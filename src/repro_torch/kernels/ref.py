"""Plain PyTorch versions of the kernels, and the 4-bit packing layout.

``lutq_matmul_ref``, ``lutq_gemv_packed_ref`` and ``kmeans_stats_ref``
are what the kernel wrappers run for a tensor on the CPU, and what the
kernels are held against on the card. Like the TPU kernels the GEMMs
cast each decoded weight
to ``x.dtype`` before the product and accumulate in float32: the matmul
runs on float32 copies of the operands, which holds every bf16 value
exactly (``jnp``'s ``x @ w`` in the reference oracle rounds a bf16
product to bf16 instead).
"""
from __future__ import annotations

import torch

from repro_torch.core.lutq import _bucketize, decode


def lutq_matmul_ref(x: torch.Tensor, a: torch.Tensor, d: torch.Tensor
                    ) -> torch.Tensor:
    """y = x @ d[a] in float32. x: (M, Kin); a: (Kin, N) int8; d: (K,)."""
    w = decode(d, a).to(x.dtype)
    return torch.matmul(x.float(), w.float())


def pack4_kin(a: torch.Tensor) -> torch.Tensor:
    """Pack two 4-bit indices per byte along axis -2 (the reduction axis).

    Row 2i goes in the low nibble and row 2i+1 in the high nibble; the
    serve-time convention is uint8 dtype == packed, int8 == raw indices.
    """
    assert a.shape[-2] % 2 == 0, a.shape
    lo = a[..., 0::2, :].to(torch.uint8) & 0xF
    hi = a[..., 1::2, :].to(torch.uint8) & 0xF
    return lo | (hi << 4)


def unpack4_kin(p: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack4_kin`: uint8 pairs -> int8 indices."""
    lo = (p & 0xF).to(torch.int8)
    hi = ((p >> 4) & 0xF).to(torch.int8)
    out = torch.stack([lo, hi], dim=-2)  # (..., Kin/2, 2, N)
    return out.reshape(*p.shape[:-2], p.shape[-2] * 2, p.shape[-1])


def lutq_gemv_packed_ref(x: torch.Tensor, packed: torch.Tensor,
                         d: torch.Tensor) -> torch.Tensor:
    """y = x @ d[unpack(packed)] in float32. packed: (Kin/2, N) uint8."""
    return lutq_matmul_ref(x, unpack4_kin(packed), d)


def kmeans_stats_ref(w: torch.Tensor, d: torch.Tensor):
    """One assignment pass over flat w against sorted d.

    Returns (assignments int8 (N,), sums (K,) f32, counts (K,) f32):
    each weight's nearest entry (ties to the lower one), then the sum
    and number of the weights assigned to each entry. Indices >= 128 of
    a K=256 dictionary wrap to negative int8, as the reference's
    ``astype(int8)`` does. Counts are exact integers rounded to f32
    once; sums accumulate in float64 and round to f32 once, so the plain
    version is the accurate side of a comparison (an f32 ``index_add_``
    over millions of weights drifts by ~1e-4 of the sum).
    """
    idx = _bucketize(w, d)
    K = d.shape[0]
    sums = torch.zeros(K, dtype=torch.float64, device=w.device)
    sums.index_add_(0, idx, w.double())
    counts = torch.bincount(idx, minlength=K).float()
    return idx.to(torch.int8), sums.float(), counts
