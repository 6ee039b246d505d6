"""Deterministic synthetic LM data (counterpart of
``repro.data.synthetic.MarkovLM``; numpy only, batches equal bit for
bit).

Tokens follow a fixed random first-order Markov chain with a
low-entropy transition matrix, so the achievable CE is well below
log(V) and training curves show real learning. Sample i is a pure
function of (seed, i), so a resumed run continues on the same batches.
"""
from __future__ import annotations

import hashlib
from typing import Dict

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
