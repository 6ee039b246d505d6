"""Deterministic synthetic data (counterpart of
``repro.data.synthetic``; numpy only, arrays equal bit for bit).

LM stream (:class:`MarkovLM`): tokens follow a fixed random first-order
Markov chain with a low-entropy transition matrix, so the achievable CE
is well below log(V) and training curves show real learning. Sample i is a pure
function of (seed, i), so a resumed run continues on the same batches.
Vision set (:func:`shapes_dataset`, :func:`class_batches`):
procedurally rendered shapes (class = shape x color) for the
CIFAR-style experiments.
"""
from __future__ import annotations

import hashlib
from typing import Dict, Iterator, Tuple

import numpy as np


def _rng(seed: int, *salts: int) -> np.random.Generator:
    h = hashlib.sha256(("/".join(map(str, (seed,) + salts))).encode()).digest()
    return np.random.Generator(np.random.PCG64(int.from_bytes(h[:8], "little")))


class MarkovLM:
    """First-order Markov chain over `vocab` tokens, temperature-controlled."""

    def __init__(self, vocab: int, seed: int = 0, branching: int = 4):
        self.vocab = vocab
        g = _rng(seed, 0xA)
        # each token transitions to `branching` preferred successors
        self.succ = g.integers(0, vocab, size=(vocab, branching))
        self.branching = branching

    def entropy_floor(self) -> float:
        """Achievable CE: uniform over `branching` successors (minus eps noise)."""
        return float(np.log(self.branching))

    def sample(self, seed: int, index: int, seq_len: int) -> np.ndarray:
        g = _rng(seed, 0xB, index)
        out = np.empty(seq_len + 1, np.int64)
        t = int(g.integers(0, self.vocab))
        for i in range(seq_len + 1):
            out[i] = t
            # 95% follow the chain, 5% jump uniformly (noise floor)
            if g.random() < 0.95:
                t = int(self.succ[t, int(g.integers(0, self.branching))])
            else:
                t = int(g.integers(0, self.vocab))
        return out

    def batch(self, seed: int, step: int, batch_size: int, seq_len: int,
              host_id: int = 0, num_hosts: int = 1) -> Dict[str, np.ndarray]:
        """Deterministic, host-sharded batch for global step `step`."""
        if batch_size % num_hosts:
            raise ValueError(f"batch {batch_size} does not split over "
                             f"{num_hosts} hosts")
        per_host = batch_size // num_hosts
        toks = np.stack([
            self.sample(seed, step * batch_size + host_id * per_host + j, seq_len)
            for j in range(per_host)
        ])
        return {"tokens": toks[:, :-1].astype(np.int32),
                "labels": toks[:, 1:].astype(np.int32)}


def shapes_dataset(n: int, seed: int = 0, res: int = 16,
                   n_classes: int = 8) -> Tuple[np.ndarray, np.ndarray]:
    """Procedural image classification: class = (shape in {square, disc,
    cross, stripes}) x (color in {warm, cold}). Returns (x: (n,res,res,3)
    in [0,1], y: (n,))."""
    g = _rng(seed, 0xC)
    xs = np.zeros((n, res, res, 3), np.float32)
    ys = np.zeros((n,), np.int64)
    yy, xx = np.mgrid[0:res, 0:res]
    for i in range(n):
        cls = int(g.integers(0, n_classes))
        shape, warm = cls % 4, cls // 4
        cx, cy = g.uniform(res * 0.3, res * 0.7, 2)
        r = g.uniform(res * 0.18, res * 0.32)
        if shape == 0:
            m = (np.abs(xx - cx) < r) & (np.abs(yy - cy) < r)
        elif shape == 1:
            m = (xx - cx) ** 2 + (yy - cy) ** 2 < r ** 2
        elif shape == 2:
            m = (np.abs(xx - cx) < r * 0.35) | (np.abs(yy - cy) < r * 0.35)
            m &= ((xx - cx) ** 2 + (yy - cy) ** 2) < (1.6 * r) ** 2
        else:
            m = ((xx + yy) % 4 < 2) & (np.abs(xx - cx) < r) & (np.abs(yy - cy) < r)
        col = np.array([0.9, 0.3, 0.1]) if warm else np.array([0.1, 0.4, 0.9])
        col = col + g.normal(0, 0.05, 3)
        img = g.normal(0.45, 0.08, (res, res, 3))
        img[m] = col + g.normal(0, 0.03, (int(m.sum()), 3))
        xs[i] = np.clip(img, 0, 1)
        ys[i] = cls
    return xs, ys


def class_batches(xs, ys, batch: int, seed: int = 0) -> Iterator[Dict[str, np.ndarray]]:
    g = _rng(seed, 0xD)
    n = len(xs)
    while True:
        idx = g.permutation(n)
        for s in range(0, n - batch + 1, batch):
            sel = idx[s:s + batch]
            yield {"x": xs[sel], "y": ys[sel].astype(np.int32)}
