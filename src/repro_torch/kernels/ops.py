"""Kernel execution-backend layer: ``lutq_dot``, the k-means stats and
paged attention.

Counterpart of ``repro.kernels.ops``: :func:`lutq_dot` resolves a
backend per quantized leaf, flattens leading dims, handles the
transposed (tied-readout) case and dispatches to the kernel wrappers;
:func:`lutq_dot_experts` is its expert-stacked form (the reference's
``jax.vmap`` of ``lutq_dot`` over a MoE layer's experts), one launch of
an expert-stacked kernel a product;
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
``pow2``     :mod:`repro_torch.kernels.lutq_shift` over a pow2 dictionary
             stored as an int8 sign+exponent plane: int8-quantized
             activations times the dictionary lowered to integer
             shifts, accumulated in int32; the only float multiply is
             the O(M*N) epilogue scale. Bit-identical to its integer
             decode oracle (the ``decode`` backend of an encoded leaf).
``auto``     per-leaf structural resolution (:func:`resolve_backend`).

The kernels take any shape and mask their own ragged edges, so the
reference's zero-padding onto TPU tiles has no counterpart here.
"""
from __future__ import annotations

import torch
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch.core.lutq import LutqState, decode_any, quantize_ste_any
from repro_torch.kernels import flash_attn as _flash_attn
from repro_torch.kernels import kmeans_stats as _kmeans_stats
from repro_torch.kernels import lutq_gemv_packed as _lutq_gemv_packed
from repro_torch.kernels import lutq_matmul as _lutq_matmul
from repro_torch.kernels import lutq_shift as _lutq_shift
from repro_torch.kernels import paged_attn as _paged_attn
from repro_torch.kernels.lutq_gemv_packed import (lutq_gemv_packed,
                                                  lutq_gemv_packed_experts)
from repro_torch.kernels.lutq_matmul import lutq_matmul, lutq_matmul_experts
from repro_torch.kernels.ref import (lutq_shift_experts_ref, lutq_shift_ref,
                                     paged_attention_ref, pow2_shift_scale,
                                     pow2_shift_weights, shift_planes,
                                     unpack4_kin)

#: Backend names accepted by ``lutq_dot`` / policy rules / CLI flags.
BACKENDS = ("auto", "decode", "fused", "packed4", "pow2")

#: calls that took the dense ``decode`` path
COUNTS = {"decode": 0}


def count_dicts():
    """Every kernel wrapper's count dict (launches and plain-version
    calls; the paged kernel's launches per variant), this module's, and
    last the expert-stacked forms' of kernels 1, 2 and 4."""
    return (_lutq_matmul.COUNTS, _lutq_gemv_packed.COUNTS,
            _lutq_shift.COUNTS, _kmeans_stats.COUNTS, _paged_attn.COUNTS,
            _paged_attn.VARIANTS, _flash_attn.COUNTS, COUNTS,
            _lutq_matmul.EXPERT_COUNTS, _lutq_gemv_packed.EXPERT_COUNTS,
            _lutq_shift.EXPERT_COUNTS)


def read_counts():
    """A copy of every count, in :func:`count_dicts` order."""
    return [dict(c) for c in count_dicts()]


def set_counts(counts) -> None:
    """Put back counts taken by :func:`read_counts`."""
    for c, v in zip(count_dicts(), counts):
        c.update(v)


def count_delta(before):
    """What the counts grew by since ``before`` (:func:`read_counts`)."""
    return [{k: c[k] - b[k] for k in c} for c, b in zip(count_dicts(),
                                                        before)]


def add_counts(delta) -> None:
    """Add a :func:`count_delta` to the counts. A captured CUDA graph's
    launches are counted while it is captured, not when it replays: the
    capture's delta is added on every replay instead."""
    for c, d in zip(count_dicts(), delta):
        for k, v in d.items():
            c[k] += v


def kmeans_stats(w: torch.Tensor, d: torch.Tensor, write_a: bool = True):
    """(assignments int8 like w, sums f32 (K,), counts f32 (K,)) of one
    assignment pass of w against sorted d; any shape of w. With
    ``write_a=False`` the assignments are None and not written."""
    return _kmeans_stats.kmeans_stats(w, d, write_a)


def kmeans_step_fused(w_flat: torch.Tensor, d: torch.Tensor):
    """One full k-means iteration through the stats kernel: assign +
    recenter (empty clusters keep their centroid). Returns (a, sorted
    new d)."""
    a, sums, counts = kmeans_stats(w_flat, d)
    new_d = torch.where(counts > 0, sums / torch.clamp(counts, min=1.0), d)
    return a, torch.sort(new_d).values


def lutq_shift(xq: torch.Tensor, a: torch.Tensor, wsh: torch.Tensor,
               planes: int = None) -> torch.Tensor:
    """int32 ``xq @ wsh[a]``: the shift-add kernel on a CUDA tensor (over
    ``planes`` digit planes of wsh, derived when None), its plain
    version on a CPU tensor."""
    return _lutq_shift.lutq_shift(xq, a, wsh, planes)


def resolve_backend(state: LutqState, backend: str = "auto", *,
                    transpose_rhs: bool = False, sliced: bool = False) -> str:
    """Concrete backend ("decode" | "fused" | "packed4" | "pow2") for one
    leaf.

    Same ladder as the reference: train-form leaves (``w`` present) and
    non-2-D assignments -> decode; a pow2-encoded dictionary (int8
    ``d``) -> pow2 unless its assignments are packed or K > 256; packed
    uint8 -> packed4 unless transposed or K > 16; int8 with K <= 256 ->
    fused. A request for pow2 on a float dictionary degrades to fused.
    A stacked leaf (an expert stack's d (E, K)) resolves to decode, as
    in the reference, unless ``sliced=True`` asks for the per-slice view
    the kernels see (:func:`lutq_dot_experts`, ``serve_view``'s
    manifest).
    """
    if backend not in BACKENDS:
        raise ValueError(
            f"unknown backend {backend!r}; expected one of {BACKENDS}")
    nstack = state.d.ndim - 1
    d_ndim = 1 if sliced else state.d.ndim
    a_ndim = state.a.ndim - nstack if sliced else state.a.ndim
    if state.w is not None or d_ndim != 1 or a_ndim != 2:
        return "decode"
    if backend == "decode":
        return "decode"
    K = state.d.shape[-1]
    if state.d.dtype == torch.int8:  # pow2 sign+exponent plane
        if state.a.dtype == torch.uint8 or K > 256:
            return "decode"
        return "pow2"
    if state.a.dtype == torch.uint8:
        if transpose_rhs or K > 16:
            return "decode"
        return "packed4"
    return "fused" if K <= 256 else "decode"


#: values derived from a serve leaf's constant tensors, per tensor
_DERIVED = WeakIdKeyDictionary()


def _derived(t: torch.Tensor, fn):
    """``fn(t)``, computed once per tensor: a serve leaf's sign+exponent
    plane and frozen pair are constants, so their shifted dictionary and
    scales are made on the first call, not on every one (the reference
    folds them under jit). Recomputed after ``t`` is written in place."""
    version = None if t.is_inference() else t._version
    per = _DERIVED.setdefault(t, {})
    hit = per.get(fn)
    if hit is None or hit[0] != version:
        hit = per[fn] = (version, fn(t))
    return hit[1]


def _positive(s: torch.Tensor) -> torch.Tensor:
    return torch.where(s > 0, s, torch.ones_like(s))


def _frozen_pair(act: torch.Tensor):
    """(scale, -qmax, qmax) of a frozen ``[scale, qmax]`` pair."""
    qmax = torch.clamp(act[..., 1].float(), max=127.0)
    return _positive(act[..., 0].float()), -qmax, qmax


def _shift_dictionary(code: torch.Tensor):
    """(shifted-integer dictionary, its epilogue scale, the kernel's digit
    planes of it) of a sign+exponent plane. The plane count is a host
    read, made here once a leaf and never a call."""
    wsh = pow2_shift_weights(code)
    return wsh, pow2_shift_scale(code), shift_planes(wsh)


def _pow2_act_quant(x2: torch.Tensor, act, experts: bool = False):
    """int8-quantize activations for the shift-add path.

    ``act`` is the leaf's frozen calibration pair ``[scale, qmax]`` or
    None for a dynamic per-call scale, ``max|x| / 127`` over every row
    of ``x2``. Returns (xq int8, scale float32 0-dim tensor). The order
    is the reference's: float32 copy, divide by the scale (a tensor on
    x's device: PyTorch multiplies by the reciprocal of a Python-number
    divisor on the card), round half to even, clip to
    ``±min(qmax, 127)``; a scale <= 0 becomes 1. With ``experts`` x2 is
    an expert stack (E, C, Kin) and each expert's slab gets its own
    scale (E,) (its own amax, or its own pair act[e]), as the
    reference's vmap over the experts takes it: an expert that received
    no token has scale 1 and quantizes to zeros.
    """
    xf = x2.float()
    if act is not None:
        s, lo, hi = _derived(act, _frozen_pair)
    else:
        hi = torch.full((), 127.0, device=x2.device)
        lo = -hi
        amax = (xf.detach().abs().amax(dim=(1, 2)) if experts
                else xf.detach().abs().max())
        s = _positive(amax / hi)
    if experts:  # one scale a slab, broadcast over its rows
        s, lo, hi = (t.reshape(-1, 1, 1) if t.ndim else t
                     for t in (s, lo, hi))
    xq = torch.clamp(torch.round(xf / s), lo, hi).to(torch.int8)
    return xq, s.reshape(-1) if experts else s


def _pow2_dot_acc(x2: torch.Tensor, code: torch.Tensor, a: torch.Tensor,
                  act, *, transpose_rhs: bool = False,
                  use_kernel: bool = True):
    """(int32 accumulator (M, N), float32 epilogue scale) of the pow2 path.

    Shared by the ``pow2`` backend (``use_kernel=True``: the shift-add
    kernel) and the integer decode oracle (``use_kernel=False``: its
    plain version on any device): the same quantization, shifted
    dictionary and int32 sums, so the two are bit-identical.
    """
    if transpose_rhs:
        a = a.T
    if a.shape[0] != x2.shape[1]:
        raise ValueError(f"pow2: Kin mismatch {tuple(x2.shape)} @ "
                         f"{tuple(a.shape)}")
    # (K,) int32 shifts, an O(K) exponent add, 2^e_min and the digit
    # planes the kernel runs
    wsh, shift_scale, planes = _derived(code, _shift_dictionary)
    xq, s = _pow2_act_quant(x2, act)
    scale = s * shift_scale  # the one float multiply factor
    if not use_kernel:
        return lutq_shift_ref(xq, a, wsh), scale
    return lutq_shift(xq, a.contiguous(), wsh, planes), scale


def _is_encoded(state: LutqState) -> bool:
    """A serve-form leaf with a pow2 sign+exponent plane and int8
    (unpacked) 2-D assignments: what the integer path reads."""
    return (state.d.dtype == torch.int8 and state.w is None
            and state.d.ndim == 1 and state.a.ndim == 2
            and state.a.dtype != torch.uint8)


def lutq_dot(x: torch.Tensor, state: LutqState, *, backend: str = "auto",
             transpose_rhs: bool = False, out_dtype=None) -> torch.Tensor:
    """``x @ d[A]`` (or ``x @ d[A].T``) through the resolved backend.

    x: (..., Kin); leading dims are flattened for the kernels and
    restored on return. Returns (..., N) in ``out_dtype`` (default
    x.dtype). The float kernels return float32 and the pow2 epilogue
    forms float32 (``acc * (act_scale * 2^e_min)``), cast here. The
    ``decode`` backend of a pow2-encoded leaf runs the integer oracle, so
    it gives the ``pow2`` backend's bits.
    """
    be = resolve_backend(state, backend, transpose_rhs=transpose_rhs)
    out_dtype = out_dtype or x.dtype

    if be == "pow2" or (be == "decode" and _is_encoded(state)):
        if be == "decode":
            COUNTS["decode"] += 1
        lead = x.shape[:-1]
        acc, scale = _pow2_dot_acc(x.reshape(-1, x.shape[-1]), state.d,
                                   state.a, state.act,
                                   transpose_rhs=transpose_rhs,
                                   use_kernel=be == "pow2")
        y = acc.float() * scale
        return y.reshape(*lead, y.shape[-1]).to(out_dtype)

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


def lutq_dot_experts(x: torch.Tensor, state: LutqState, *,
                     backend: str = "auto", out_dtype=None) -> torch.Tensor:
    """Expert-stacked ``x[e] @ d[e][A[e]]``: the reference's ``jax.vmap``
    of :func:`lutq_dot` over a MoE layer's experts.

    x: (E, C, Kin), a serve-form expert leaf: d (E, K) (or its int8
    sign+exponent planes), a (E, Kin, N) int8 or (E, Kin/2, N) packed.
    Returns (E, C, N) in ``out_dtype`` (default x.dtype). The backend is
    resolved per slice (``resolve_backend(..., sliced=True)``); each of
    ``fused``, ``packed4`` and ``pow2`` is ONE launch of its
    expert-stacked kernel for all E products. Activations arrive
    quantized as the caller scoped them (``nn/moe._expert_dot``: one
    fake-quant over the whole dispatch buffer), except on the pow2 path,
    which takes its int8 scale per expert slab (dynamic) or from each
    expert's frozen pair, as the vmapped ``_pow2_act_quant`` does; its
    epilogue is ``acc[e] * (s[e] * 2^e_min[e])``. ``decode`` runs the
    plain products (the integer oracle on an encoded leaf).
    """
    be = resolve_backend(state, backend, sliced=True)
    out_dtype = out_dtype or x.dtype
    encoded = state.d.dtype == torch.int8 and state.a.dtype != torch.uint8
    if be == "pow2" or (be == "decode" and encoded):
        wsh, shift_scale, planes = _derived(state.d, _shift_dictionary)
        xq, s = _pow2_act_quant(x, state.act, experts=True)
        if be == "pow2":
            acc = _lutq_shift.lutq_shift_experts(xq.contiguous(),
                                                 state.a.contiguous(), wsh,
                                                 planes)
        else:
            COUNTS["decode"] += 1
            acc = lutq_shift_experts_ref(xq, state.a, wsh)
        scale = (s * shift_scale).reshape(-1, 1, 1)
        return (acc.float() * scale).to(out_dtype)
    if be == "decode":
        COUNTS["decode"] += 1
        a = state.a
        if a.dtype == torch.uint8:
            a = unpack4_kin(a)
        w = decode_any(state.d, a).to(x.dtype)
        return torch.matmul(x, w).to(out_dtype)
    x = x.contiguous()
    if be == "fused":
        y = lutq_matmul_experts(x, state.a, state.d)
    else:
        y = lutq_gemv_packed_experts(x, state.a, state.d)
    return y.to(out_dtype)


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
    ported yet (ROADMAP queue 1, multi-GPU; tuning and benches).
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
