"""Rotary position embeddings (GPT-NeoX convention, half-split).

Counterpart of ``repro.nn.rotary``: the doubled inverse frequencies and
the rotate-half sign mask are host (numpy) tables, and the rotate-half
is a roll times the sign mask.
"""
from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=64)
def _rope_tables(head_dim: int, theta: float):
    """(inv_freq doubled, rotate-half sign mask) as host constants."""
    half = head_dim // 2
    inv = 1.0 / (theta ** (np.arange(0, half, dtype=np.float32) / half))
    inv2 = np.concatenate([inv, inv])
    sign = np.concatenate([-np.ones(half, np.float32),
                           np.ones(half, np.float32)])
    return inv2, sign


@functools.lru_cache(maxsize=None)
def _rope_tables_on(head_dim: int, theta: float, device: torch.device):
    """The host tables, copied to ``device`` once (a copy from pageable
    host memory waits for the device, so it must not run per call) and
    never dropped (a captured CUDA graph reads them where they are).
    Made outside inference mode, so that a cache first filled while
    serving still serves a forward that autograd records."""
    with torch.inference_mode(False):
        return tuple(torch.from_numpy(t).to(device)
                     for t in _rope_tables(head_dim, theta))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """x: (..., S, H, Dh) or (..., S, Dh); positions: (..., S)."""
    dh = x.shape[-1]
    half = dh // 2
    inv2, sign = _rope_tables_on(dh, float(theta), x.device)
    ang = positions[..., None].float() * inv2  # (..., S, dh)
    if x.ndim == ang.ndim + 1:  # head axis present
        ang = ang[..., None, :]
    xf = x.float()
    rot = torch.roll(xf, half, dims=-1) * sign  # (-x2, x1)
    return (xf * torch.cos(ang) + rot * torch.sin(ang)).to(x.dtype)
