"""Kernel execution-backend layer: ``lutq_dot``, the k-means stats and
paged attention.

Counterpart of ``repro.kernels.ops``: :func:`lutq_dot` resolves a
backend per quantized leaf, flattens leading dims, handles the
transposed (tied-readout) case and dispatches to the kernel wrappers;
:func:`kmeans_stats` and :func:`kmeans_step_fused` are training step 4's
entry points to the ``kmeans_stats`` kernel; :func:`paged_attention` is
paged decode's entry point to the ``paged_attn`` kernels.

Backends
--------
``decode``   dense: ``x @ d[A]`` with the decoded weight materialized
             (through the STE on a train-form leaf).
``fused``    :mod:`repro_torch.kernels.lutq_matmul` over int8 assignments.
``packed4``  :mod:`repro_torch.kernels.lutq_gemv_packed` over packed
             4-bit pairs.
``pow2``     not ported yet (ROADMAP queue 1 item 4): a pow2-encoded
             dictionary raises.
``auto``     per-leaf structural resolution (:func:`resolve_backend`).

The kernels take any shape and mask their own ragged edges, so the
reference's zero-padding onto TPU tiles has no counterpart here.
"""
from __future__ import annotations

import torch

from repro_torch.core.lutq import LutqState, decode_any, quantize_ste_any
from repro_torch.kernels import kmeans_stats as _kmeans_stats
from repro_torch.kernels import paged_attn as _paged_attn
from repro_torch.kernels.lutq_gemv_packed import lutq_gemv_packed
from repro_torch.kernels.lutq_matmul import lutq_matmul
from repro_torch.kernels.ref import paged_attention_ref, unpack4_kin

#: Backend names accepted by ``lutq_dot`` / policy rules / CLI flags.
BACKENDS = ("auto", "decode", "fused", "packed4", "pow2")

#: calls that took the dense ``decode`` path
COUNTS = {"decode": 0}


def kmeans_stats(w: torch.Tensor, d: torch.Tensor):
    """(assignments int8 like w, sums f32 (K,), counts f32 (K,)) of one
    assignment pass of w against sorted d; any shape of w."""
    return _kmeans_stats.kmeans_stats(w, d)


def kmeans_step_fused(w_flat: torch.Tensor, d: torch.Tensor):
    """One full k-means iteration through the stats kernel: assign +
    recenter (empty clusters keep their centroid). Returns (a, sorted
    new d)."""
    a, sums, counts = kmeans_stats(w_flat, d)
    new_d = torch.where(counts > 0, sums / torch.clamp(counts, min=1.0), d)
    return a, torch.sort(new_d).values


_POW2_TODO = ("the pow2 shift-add backend is not ported yet "
              "(ROADMAP queue 1 item 4, queue 2 kernel 4)")


def resolve_backend(state: LutqState, backend: str = "auto", *,
                    transpose_rhs: bool = False) -> str:
    """Concrete backend ("decode" | "fused" | "packed4") for one leaf.

    Same ladder as the reference: train-form leaves (``w`` present) and
    non-2-D assignments -> decode; packed uint8 -> packed4 unless
    transposed or K > 16; int8 with K <= 256 -> fused. The port's
    leaves are per layer, so the reference's per-slice resolution of a
    stacked leaf is the only one there is.
    """
    if backend not in BACKENDS:
        raise ValueError(
            f"unknown backend {backend!r}; expected one of {BACKENDS}")
    if state.w is not None or state.d.ndim != 1 or state.a.ndim != 2:
        return "decode"
    if backend == "decode":
        return "decode"
    K = state.d.shape[-1]
    if state.d.dtype == torch.int8:
        raise NotImplementedError(_POW2_TODO)
    if state.a.dtype == torch.uint8:
        if transpose_rhs or K > 16:
            return "decode"
        return "packed4"
    return "fused" if K <= 256 else "decode"


def lutq_dot(x: torch.Tensor, state: LutqState, *, backend: str = "auto",
             transpose_rhs: bool = False, out_dtype=None) -> torch.Tensor:
    """``x @ d[A]`` (or ``x @ d[A].T``) through the resolved backend.

    x: (..., Kin); leading dims are flattened for the kernels and
    restored on return. Returns (..., N) in ``out_dtype`` (default
    x.dtype). The kernels return float32, cast here.
    """
    be = resolve_backend(state, backend, transpose_rhs=transpose_rhs)
    out_dtype = out_dtype or x.dtype

    if be == "decode":
        COUNTS["decode"] += 1
        a = state.a
        if a.dtype == torch.uint8:
            a = unpack4_kin(a)
        if state.w is not None:
            w = quantize_ste_any(state.w, state.d, a)
        else:
            w = decode_any(state.d, a)
        w = w.to(x.dtype)
        if transpose_rhs:
            w = w.transpose(-1, -2)
        return torch.matmul(x, w).to(out_dtype)

    lead, Kin = x.shape[:-1], x.shape[-1]
    x2 = x.reshape(-1, Kin).contiguous()
    if be == "fused":
        # transposed use (tied readout) copies the assignments once per
        # call: the kernel reads a (Kin, N) row-major matrix
        a = state.a.T.contiguous() if transpose_rhs else state.a
        y = lutq_matmul(x2, a, state.d)
    else:
        y = lutq_gemv_packed(x2, state.a, state.d)
    return y.reshape(*lead, y.shape[-1]).to(out_dtype)


# ---------------------------------------------------------------------------
# paged attention (decode)
# ---------------------------------------------------------------------------

#: dispatch names accepted by :func:`paged_attention`
PAGED_BACKENDS = ("auto", "kernel", "gather")


def paged_attention(q, k_pool, v_pool, block, cache_len, *, window=None,
                    scale=None, k_scale=None, v_scale=None, backend="auto",
                    smem_budget_bytes=None):
    """One-token decode attention over a paged KV pool.

    q: (B, 1, H, dh); k_pool/v_pool: (P, page, Hkv, dh); block: (B, NB)
    int32 block table; cache_len: (B,) or scalar valid lengths. int8
    pools carry bf16 per-token scale planes (P, page, Hkv).

    ``"kernel"`` and ``"auto"`` walk the block table in the CUDA kernel
    on a CUDA tensor (:mod:`repro_torch.kernels.paged_attn`, variant by
    ``smem_budget_bytes``) and run its plain version on a CPU tensor;
    ``"gather"`` is the plain version (gather, dequantize, attend) on
    any device. The reference's ``mesh`` and autotuned ``auto`` are not
    ported yet (ROADMAP queue 1 items 8 and 9).
    """
    if backend not in PAGED_BACKENDS:
        raise ValueError(f"backend={backend!r} not in {PAGED_BACKENDS}")
    if backend == "gather":
        cl = torch.as_tensor(cache_len, device=q.device).reshape(-1)
        return paged_attention_ref(q, k_pool, v_pool, block,
                                   cl.expand(q.shape[0]), window=window,
                                   scale=scale, k_scale=k_scale,
                                   v_scale=v_scale)
    return _paged_attn.paged_attention(
        q, k_pool, v_pool, block, cache_len, window=window, scale=scale,
        k_scale=k_scale, v_scale=v_scale,
        smem_budget_bytes=smem_budget_bytes)
