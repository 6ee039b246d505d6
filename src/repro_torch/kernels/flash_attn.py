"""Blocked causal (or full) attention with an online softmax.

Counterpart of ``repro.kernels.flash_attn.flash_attention_tpu`` (kernel
5): q (BH, S, D), k and v (BH, Skv, D), batch and heads flattened, GQA
fed with each KV head repeated for its query heads. On a CUDA tensor
:func:`flash_attention` launches one of the hand-written kernels in
``csrc/flash_attn.cu``, the one :func:`plan` names from the shapes, or
raises; on a CPU tensor it runs the plain version,
:func:`repro_torch.kernels.ref.flash_attention_ref`. The kernels:

- ``flash_wgmma`` (bf16, ``bq`` a multiple of 64 or all of S, ``bk`` in
  :data:`WGMMA_BK`): a persistent grid, K/V tiles streamed by TMA from a
  producer warpgroup, ``wgmma`` products with q and the probabilities in
  registers, the softmax in base 2 with the scale folded into its FMA
  (:func:`repro_torch.kernels.ref.flash_attention_exp2_ref` emulates that
  order);
- ``flash_bf16`` (the other bf16 calls): ``mma.sync`` products;
- ``flash_f32``: f32 on CUDA cores.

Each walks the kv blocks of ``bk`` rows as the reference does, so its
running max moves where the reference's does; under ``causal`` none
reads a kv block that the reference skips. Their limits, checked on
either device: D a multiple of 16 up to 128, ``bk`` (after ``min(bk,
Skv)``) a multiple of 16 up to 128, and ``bq`` (after ``min(bq, S)``) a
multiple of 16 or all of S.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import audit, build
from repro_torch.kernels.ref import flash_attention_ref

#: launches of the kernels (all, and by kernel), and calls that ran the
#: plain version
COUNTS = {"launches": 0, "plain": 0, "flash_wgmma": 0, "flash_bf16": 0,
          "flash_f32": 0}

#: the kernels' limits: head dim and kv tile, each a multiple of 16
MAX_D, MAX_BK, STEP = 128, 128, 16
#: the query rows of one warpgroup of ``flash_wgmma``, and the kv tiles it
#: is compiled for
WG_ROWS = 64
WGMMA_BK = (16, 32, 64, 128)
#: the launcher's code of each kernel
KERNEL_CODES = {"flash_f32": 0, "flash_bf16": 1, "flash_wgmma": 2}
#: the most query-row tiles of a launch (the grid's second axis); the
#: kernels' tiles hold at least 64 rows
MAX_TILES = 65535
TILE_ROWS = 64

_DTYPES = (torch.float32, torch.bfloat16)


def plan(S: int, Skv: int, D: int, bq: int, bk: int, dtype) -> str:
    """The kernel a call of these shapes launches, from the shapes alone.

    f32 goes to ``flash_f32``. bf16 goes to ``flash_wgmma`` when every
    64-row warpgroup lies in one of the reference's q blocks (``bq`` a
    multiple of 64, or ``bq == S``: one q block) and ``bk`` is one of
    :data:`WGMMA_BK`; else to ``flash_bf16``, whose 16-row warps lie in
    one q block for any ``bq`` the wrapper accepts. ``bq`` and ``bk`` are
    taken after ``min(bq, S)`` and ``min(bk, Skv)``; D does not choose.
    """
    del D
    if dtype == torch.float32:
        return "flash_f32"
    bq, bk = min(bq, S), min(bk, Skv)
    if (bq % WG_ROWS == 0 or bq == S) and bk in WGMMA_BK:
        return "flash_wgmma"
    return "flash_bf16"


def _check_shapes(q, k, v, bq, bk):
    """Raise on what the kernels do not take; return ``(min(bq, S),
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
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
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


def launch(kernel: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           *, causal: bool, scale: float, bk: int) -> torch.Tensor:
    """Launch the named kernel on CUDA tensors whose shapes
    :func:`flash_attention` checked; returns (BH, S, D) in q's dtype.

    :func:`flash_attention` launches the kernel :func:`plan` names; a
    caller that names another (a timing of one kernel beside another on
    the same operands) answers for the q blocks it stands for: every
    kernel reads the kv tiles up to each warpgroup's, warp's or row's
    last row.
    """
    if kernel not in KERNEL_CODES:
        raise ValueError(f"flash_attention: no kernel {kernel!r}")
    if (kernel == "flash_f32") != (q.dtype == torch.float32):
        raise ValueError(f"flash_attention: {kernel} does not take {q.dtype}")
    if kernel == "flash_wgmma" and bk not in WGMMA_BK:
        raise ValueError(f"flash_attention: flash_wgmma takes bk in "
                         f"{WGMMA_BK}, got {bk}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"flash_attention: {name} is on {t.device}, "
                             f"expected the CUDA device of q")
        if not t.is_contiguous():
            raise ValueError(f"flash_attention: {name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"flash_attention: {name} must start on a "
                             f"16-byte boundary")
    BH, S, D = q.shape
    Skv = k.shape[1]
    if -(-S // TILE_ROWS) > MAX_TILES:
        raise ValueError(f"flash_attention: at most {MAX_TILES * TILE_ROWS} "
                         f"query rows, got S={S}")
    out = torch.empty_like(q)
    lib = build.load_library()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = lib.flash_attention_launch(
        q.device.index, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), KERNEL_CODES[kernel], BH, S, Skv, D, bk, int(causal),
        float(scale), stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention: CUDA error {rc} at launch of "
                           f"{kernel} (BH={BH}, S={S}, Skv={Skv}, D={D}, "
                           f"bk={bk}, {q.dtype})")
    COUNTS["launches"] += 1
    COUNTS[kernel] += 1
    if audit.RECORDER is not None:
        audit.note("flash_attention", q.dtype, q.shape, k.shape, out.shape)
    return out


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
    return launch(plan(S, Skv, D, bq, bk, q.dtype), q, k, v, causal=causal,
                  scale=scale, bk=bk)
