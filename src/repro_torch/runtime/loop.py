"""Fault-tolerant training loop: auto-resume, SIGTERM checkpointing,
straggler watchdog, deterministic data skip-ahead.

Counterpart of ``repro.runtime.loop``, single process:
  * auto-resume: restores the latest complete checkpoint on start and
    continues at its step, on the batch of that step (``make_batch`` is
    a pure function of the step);
  * preemption: SIGTERM/SIGUSR1 ends the loop after the current step
    with a final synchronous checkpoint;
  * straggler watchdog: flags sync windows whose per-step time exceeds
    ``factor`` x the trailing median.
Metrics stay device tensors between sync points (the log/checkpoint
cadence and the loop's end), so the host runs ahead of the card between
them, as the reference's pending device handles do.
"""
from __future__ import annotations

import signal
import statistics
import threading
import time
from typing import Any, Callable, Dict, List, Optional

import torch

from repro_torch.checkpoint.ckpt import AsyncCheckpointer, latest_step, restore
from repro_torch.interop import load_train_state


class StragglerWatchdog:
    def __init__(self, factor: float = 3.0, window: int = 32):
        self.factor = factor
        self.times: List[float] = []
        self.window = window
        self.flagged = 0

    def observe(self, dt: float) -> bool:
        slow = False
        if len(self.times) >= 8:
            med = statistics.median(self.times[-self.window:])
            if dt > self.factor * med:
                self.flagged += 1
                slow = True
        self.times.append(dt)
        return slow


def _scalar(v) -> Optional[float]:
    if isinstance(v, torch.Tensor):
        return float(v) if v.dim() == 0 else None
    return float(v)


class TrainLoop:
    def __init__(
        self,
        train_step: Callable,
        make_batch: Callable[[int], Dict[str, Any]],
        *,
        ckpt_dir: Optional[str] = None,
        ckpt_every: int = 100,
        keep_n: int = 3,
        log_every: int = 10,
        log_fn: Callable[[str], None] = print,
        quant_policy=None,
    ):
        self.train_step = train_step
        self.make_batch = make_batch
        self.ckpt_dir = ckpt_dir
        self.ckpt_every = ckpt_every
        self.log_every = log_every
        self.log = log_fn
        self.watchdog = StragglerWatchdog()
        self.ckpt = (AsyncCheckpointer(ckpt_dir, keep_n, policy=quant_policy)
                     if ckpt_dir else None)
        self._preempted = threading.Event()
        self.history: List[Dict[str, float]] = []

    def _install_signal_handlers(self):
        def handler(signum, frame):
            self.log(f"[loop] signal {signum}: checkpoint-and-exit requested")
            self._preempted.set()
        try:
            signal.signal(signal.SIGTERM, handler)
            signal.signal(signal.SIGUSR1, handler)
        except ValueError:
            pass  # not main thread (tests)

    def maybe_resume(self, state):
        """Restore the latest checkpoint into ``state`` (in place) if there
        is one; returns (state, start_step)."""
        if not self.ckpt_dir:
            return state, 0
        last = latest_step(self.ckpt_dir)
        if last is None:
            return state, 0
        tree, step = restore(self.ckpt_dir, last)
        load_train_state(state, tree)
        self.log(f"[loop] resumed from step {step}")
        return state, int(step)

    def run(self, state, num_steps: int, *, handle_signals: bool = True):
        if handle_signals:
            self._install_signal_handlers()
        state, start = self.maybe_resume(state)
        step = start
        pending: List[tuple] = []
        t_mark = time.perf_counter()

        def drain():
            nonlocal t_mark
            if not pending:
                return
            # newest first: reading its metrics waits for the card
            recs = [(s, {k: _scalar(v) for k, v in m.items()})
                    for s, m in reversed(pending)][::-1]
            dt = (time.perf_counter() - t_mark) / len(pending)
            t_mark = time.perf_counter()
            slow = self.watchdog.observe(dt)
            for s, vals in recs:
                self.history.append(
                    {"step": s, "dt": dt,
                     **{k: v for k, v in vals.items() if v is not None}})
            if slow:
                self.log(f"[watchdog] window at step {pending[-1][0]} "
                         f"straggled: {dt*1e3:.1f} ms/step (median "
                         f"{statistics.median(self.watchdog.times[-32:])*1e3:.1f} ms)")
            pending.clear()

        while step < num_steps and not self._preempted.is_set():
            batch = self.make_batch(step)
            state, metrics = self.train_step(state, batch)
            pending.append((step, metrics))
            step += 1
            due_ckpt = self.ckpt and (step % self.ckpt_every == 0)
            if (step % self.log_every == 0) or due_ckpt:
                drain()
            if step % self.log_every == 0 and self.history:
                rec = self.history[-1]
                self.log(f"[train] step {rec['step']} "
                         f"loss {rec.get('loss', float('nan')):.4f} "
                         f"{rec['dt']*1e3:.1f} ms")
            if due_ckpt:
                self.ckpt.save(state, step)
        drain()
        if self.ckpt and (self._preempted.is_set() or step >= num_steps):
            self.ckpt.save(state, step)
            self.ckpt.wait()
            self.log(f"[loop] final checkpoint at step {step}")
        return state, step
