"""Byte-level text pipeline over local files (counterpart of
``repro.data.text``; numpy only, arrays equal bit for bit).

Concatenates files into one byte stream and yields deterministic
host-sharded (tokens, labels) windows. Vocab = 256 bytes. The arrays
stay numpy: the caller moves them to its device.
"""
from __future__ import annotations

import os
from pathlib import Path
from typing import Dict, Iterable, List

import numpy as np


def load_corpus(paths: Iterable[str], max_bytes: int = 8 << 20) -> np.ndarray:
    """The files in sorted path order, joined by b"\\n" and cut at
    ``max_bytes``, as int32 byte tokens. Unreadable files are skipped;
    an empty corpus raises ValueError."""
    bufs: List[bytes] = []
    total = 0
    for p in sorted(map(str, paths)):
        try:
            b = Path(p).read_bytes()
        except OSError:
            continue
        bufs.append(b)
        total += len(b)
        if total >= max_bytes:
            break
    data = b"\n".join(bufs)[:max_bytes]
    if not data:
        raise ValueError("empty corpus")
    return np.frombuffer(data, dtype=np.uint8).astype(np.int32)


def default_corpus(root: str = ".") -> np.ndarray:
    """The ``.py``, ``.md``, ``.toml`` and ``.txt`` files under ``root``
    (outside dot directories) as a corpus: a source tree is always at
    hand."""
    paths = []
    for dirpath, _, files in os.walk(root):
        if any(part.startswith(".") for part in Path(dirpath).parts):
            continue
        for f in files:
            if f.endswith((".py", ".md", ".toml", ".txt")):
                paths.append(os.path.join(dirpath, f))
    return load_corpus(paths)


def byte_batch(corpus: np.ndarray, step: int, batch_size: int, seq_len: int,
               *, host_id: int = 0, num_hosts: int = 1, seed: int = 0
               ) -> Dict[str, np.ndarray]:
    """Deterministic window sampling: sample i of step s is a pure
    function of (seed, s, i), so a resumed run needs no state."""
    if batch_size % num_hosts:
        raise ValueError(f"batch {batch_size} does not split over "
                         f"{num_hosts} hosts")
    per_host = batch_size // num_hosts
    n = len(corpus) - seq_len - 1
    idx = np.arange(per_host) + host_id * per_host + step * batch_size
    base = np.random.Generator(np.random.PCG64(seed)).integers(0, n)
    starts = (base + idx * 2654435761) % n  # Knuth multiplicative hash walk
    toks = np.stack([corpus[s:s + seq_len + 1] for s in starts])
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
