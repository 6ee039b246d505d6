"""Blocked causal (or full) attention with an online softmax.

Counterpart of ``repro.kernels.flash_attn.flash_attention_tpu`` (kernel
5): q (BH, S, D), k and v (BH, Skv, D), batch and heads flattened, GQA
fed with each KV head repeated for its query heads. On a CUDA tensor
:func:`flash_attention` launches the hand-written kernel in
``csrc/flash_attn.cu`` (bf16 products on tensor cores through
``mma.sync``, f32 on CUDA cores) or raises; on a CPU tensor it runs the
plain version, :func:`repro_torch.kernels.ref.flash_attention_ref`.

The kernel walks the kv blocks of ``bk`` rows as the reference does, so
its running max moves where the reference's does; under ``causal`` it
never reads a kv block that the reference skips. Its limits, checked on
either device: D a multiple of 16 up to 128, ``bk`` (after ``min(bk,
Skv)``) a multiple of 16 up to 128, and ``bq`` (after ``min(bq, S)``) a
multiple of 16 or all of S, so that the 16 query rows of a warp lie in
one of the reference's q blocks.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import flash_attention_ref

#: launches of the kernel, and calls that ran the plain version
COUNTS = {"launches": 0, "plain": 0}

#: the kernel's limits: head dim and kv tile, each a multiple of 16
MAX_D, MAX_BK, STEP = 128, 128, 16
#: the query rows of one thread block (four warps of 16 rows) in the
#: bf16 kernel; the f32 kernel gives each thread one row
TILE_ROWS = 64

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _check_shapes(q, k, v, bq, bk):
    """Raise on what the kernel does not take; return ``(min(bq, S),
    min(bk, Skv))``."""
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise ValueError(f"flash_attention: q, k, v must be (BH, S, D), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    BH, S, D = q.shape
    if 0 in (BH, S, k.shape[1]):
        raise ValueError(f"flash_attention: empty operands {tuple(q.shape)}, "
                         f"{tuple(k.shape)}")
    if k.shape != v.shape or k.shape[0] != BH or k.shape[2] != D:
        raise ValueError(f"flash_attention: k and v must be (BH={BH}, Skv, "
                         f"D={D}), got {tuple(k.shape)} and {tuple(v.shape)}")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or \
            v.dtype != q.dtype:
        raise ValueError(f"flash_attention: q, k, v must share a float32 or "
                         f"bfloat16 dtype, got {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")
    Skv = k.shape[1]
    bq, bk = min(bq, S), min(bk, Skv)
    if S % bq or Skv % bk:
        raise ValueError(f"flash_attention: S={S} must be a multiple of "
                         f"bq={bq} and Skv={Skv} of bk={bk}")
    if D % STEP or not STEP <= D <= MAX_D:
        raise ValueError(f"flash_attention: the kernel takes a head dim that "
                         f"is a multiple of {STEP} up to {MAX_D}, got {D}")
    if bk % STEP or bk > MAX_BK:
        raise ValueError(f"flash_attention: the kernel takes a kv block that "
                         f"is a multiple of {STEP} up to {MAX_BK}, got "
                         f"bk={bk}")
    if bq % STEP and bq != S:
        raise ValueError(f"flash_attention: the kernel takes a q block that "
                         f"is a multiple of {STEP} or all of S={S}, got "
                         f"bq={bq}")
    return bq, bk


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, scale: Optional[float] = None,
                    bq: int = 128, bk: int = 128) -> torch.Tensor:
    """Attention of each (batch·head) row; returns (BH, S, D) in q's dtype.

    ``scale`` defaults to ``D ** -0.5``; ``bq = min(bq, S)`` and ``bk =
    min(bk, Skv)`` must divide S and Skv. Under ``causal`` query row r
    sees kv rows ``<= r`` (no offset when ``Skv != S``).
    """
    bq, bk = _check_shapes(q, k, v, bq, bk)
    BH, S, D = q.shape
    Skv = k.shape[1]
    if scale is None:
        scale = D ** -0.5
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"flash_attention: {name} is on {t.device}, q on "
                             f"{q.device}")
    if q.device.type == "cpu":
        COUNTS["plain"] += 1
        return flash_attention_ref(q, k, v, causal=causal, scale=scale,
                                   bq=bq, bk=bk)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: q is on {q.device}, expected a "
                         f"CUDA tensor")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"flash_attention: {name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"flash_attention: {name} must start on a "
                             f"16-byte boundary")
    if -(-S // TILE_ROWS) > 65535:
        raise ValueError(f"flash_attention: at most {65535 * TILE_ROWS} query "
                         f"rows, got S={S}")
    out = torch.empty_like(q)
    lib = build.load_library()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = lib.flash_attention_launch(
        q.device.index, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), _DTYPE_CODE[q.dtype], BH, S, Skv, D, bk, int(causal),
        float(scale), stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention: CUDA error {rc} at launch "
                           f"(BH={BH}, S={S}, Skv={Skv}, D={D}, bk={bk}, "
                           f"{q.dtype})")
    COUNTS["launches"] += 1
    return out
