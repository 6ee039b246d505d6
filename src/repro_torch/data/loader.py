"""Prefetching loader: builds the next batches on a background thread
while the card runs the current step (counterpart of
``repro.data.loader``)."""
from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Iterator, Tuple


class Prefetcher:
    """Pulls ``make_batch(step)`` for step = start_step, start_step + 1,
    ... on a background thread, at most ``depth`` ahead.

    Deterministic: the batch of step s is always make_batch(s), whatever
    the depth, so a run restored at step s starts a Prefetcher there.
    An exception raised by ``make_batch`` ends the thread and is raised
    by the ``next()`` that would have returned that step's batch (the
    reference's thread dies and leaves ``next()`` waiting forever).
    """

    def __init__(self, make_batch: Callable[[int], Any],
                 start_step: int = 0, depth: int = 2):
        self._make = make_batch
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._step = start_step
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _put(self, item) -> bool:
        """Queue ``item`` unless close() comes first; True if queued."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def _run(self):
        s = self._step
        while not self._stop.is_set():
            try:
                item = (s, self._make(s), None)
            except Exception as e:  # handed to the consumer by __next__
                self._put((s, None, e))
                return
            if self._put(item):
                s += 1

    def __iter__(self) -> Iterator[Tuple[int, Any]]:
        return self

    def __next__(self) -> Tuple[int, Any]:
        step, batch, err = self._q.get()
        if err is not None:
            raise err
        return step, batch

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2.0)
