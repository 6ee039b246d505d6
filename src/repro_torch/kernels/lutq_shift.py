"""Shift-add LUT matmul of the multiplier-less pow2 path: the exact int32
accumulator ``acc = xq @ wsh[A]``.

Counterpart of ``repro.kernels.lutq_shift`` (the ``pow2`` backend of
``kernels.ops.lutq_dot``). On a CUDA tensor it launches the hand-written
CUDA kernel of ``csrc/lutq_shift.cu`` or raises; on a CPU tensor it runs
the plain version, :func:`repro_torch.kernels.ref.lutq_shift_ref`.

xq (M, Kin) int8 quantized activations; a (Kin, N) int8 assignments
(read as unsigned bytes); wsh (K <= 256,) int32 shifted-integer
dictionary (:func:`repro_torch.kernels.ref.pow2_shift_weights`);
returns (M, N) int32, any M, N and Kin. Integer sums make the result
bit-identical to the plain version under any tiling or split.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import lutq_shift_ref

#: launches of the kernel, and calls that ran the plain version instead
COUNTS = {"launches": 0, "plain": 0}

#: the kernels' tiles: columns a decode block covers, reduction rows a
#: decode block holds at most; the prefill kernel's output tile
GEMV_BN, GEMV_MAX_ROWS, GEMM_BM, GEMM_BN = 512, 512, 64, 128
#: rows per step of the reduction split, and blocks wanted per SM
SPLIT_STEP, BLOCKS_PER_SM = 32, 4


def plan_splits(M: int, N: int, Kin: int, sms: int):
    """(splits, kchunk): reduction split of a (M, N, Kin) product.

    With fewer output tiles than ``BLOCKS_PER_SM`` blocks an SM, the
    reduction is cut into chunks of a multiple of 32 rows so that about
    that many blocks read assignments; a decode block (M <= 8) holds at
    most 512 rows of xq. The blocks add their partial sums into the
    output with integer atomics.
    """
    tiles = (-(-N // GEMV_BN) if M <= 8
             else -(-N // GEMM_BN) * -(-M // GEMM_BM))
    want = max(1, -(-BLOCKS_PER_SM * sms // tiles))
    kchunk = -(-(-(-Kin // want)) // SPLIT_STEP) * SPLIT_STEP
    if M <= 8:
        kchunk = min(kchunk, GEMV_MAX_ROWS)
    kchunk = min(kchunk, Kin)
    return -(-Kin // kchunk), kchunk


def _alignment(a: torch.Tensor, N: int) -> int:
    """Widest load (16, 4 or 1 bytes) that every row of ``a`` allows."""
    for width in (16, 4):
        if a.data_ptr() % width == 0 and N % width == 0:
            return width
    return 1


def lutq_shift(xq: torch.Tensor, a: torch.Tensor, wsh: torch.Tensor
               ) -> torch.Tensor:
    if xq.dim() != 2 or a.dim() != 2 or wsh.dim() != 1:
        raise ValueError(f"lutq_shift: want xq (M, Kin), a (Kin, N), wsh "
                         f"(K,); got {tuple(xq.shape)}, {tuple(a.shape)}, "
                         f"{tuple(wsh.shape)}")
    if a.shape[0] != xq.shape[1]:
        raise ValueError(f"lutq_shift: Kin mismatch {tuple(xq.shape)} @ "
                         f"{tuple(a.shape)}")
    if xq.dtype != torch.int8:
        raise TypeError(f"lutq_shift: xq must be int8, got {xq.dtype}")
    if a.dtype not in (torch.int8, torch.uint8):
        raise TypeError(f"lutq_shift: a must be int8, got {a.dtype}")
    if wsh.dtype != torch.int32 or not 1 <= wsh.numel() <= 256:
        raise TypeError("lutq_shift: wsh must be int32 with 1..256 entries")
    if xq.device.type == "cpu":
        COUNTS["plain"] += 1
        return lutq_shift_ref(xq, a, wsh)
    for name, t in (("xq", xq), ("a", a), ("wsh", wsh)):
        if t.device.type != "cuda" or t.device != xq.device:
            raise ValueError(f"lutq_shift: {name} is on {t.device}, expected "
                             f"xq's CUDA device")
        if not t.is_contiguous():
            raise ValueError(f"lutq_shift: {name} must be contiguous")
    (M, Kin), N = xq.shape, a.shape[1]
    if M == 0 or N == 0 or Kin == 0:
        raise ValueError(f"lutq_shift: empty product {(M, Kin, N)}")
    splits, kchunk = plan_splits(M, N, Kin, build.sm_count(xq.device))
    y = torch.empty((M, N), dtype=torch.int32, device=xq.device)
    stream = torch.cuda.current_stream(xq.device).cuda_stream
    rc = build.load_library().lutq_shift_launch(
        xq.device.index, xq.data_ptr(), a.data_ptr(), _alignment(a, N),
        wsh.data_ptr(), wsh.numel(), y.data_ptr(), M, N, Kin, splits, kchunk,
        stream)
    if rc != 0:
        raise RuntimeError(f"lutq_shift: CUDA error {rc} at launch (M={M}, "
                           f"N={N}, Kin={Kin}, splits={splits})")
    COUNTS["launches"] += 1
    return y
