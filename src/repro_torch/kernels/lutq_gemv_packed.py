"""Packed 4-bit LUT-decode matmul: ``y = x @ d[unpack4(P)]``.

Counterpart of ``repro.kernels.lutq_gemv_packed`` (the ``packed4``
backend of ``kernels.ops.lutq_dot``), for every M, not only decode. On a
CUDA tensor it launches the hand-written CUDA kernel of
``csrc/lutq_gemv_packed.cu`` or raises; on a CPU tensor it runs the
plain version, :func:`repro_torch.kernels.ref.lutq_gemv_packed_ref`.

x (M, Kin) float32/bfloat16, Kin even; packed (Kin/2, N) uint8 with row
2i in the low nibble; d (K <= 16,) float32; y (M, N) float32.

:func:`lutq_gemv_packed_experts` is the expert-stacked form: x (E, C,
Kin), packed (E, Kin/2, N), d (E, K) -> y (E, C, N), one launch for
every expert.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import audit, build
from repro_torch.kernels.ref import (lutq_gemv_packed_experts_ref,
                                     lutq_gemv_packed_ref)

#: launches of the kernel, and calls that ran the plain version instead
COUNTS = {"launches": 0, "plain": 0}
#: the same for the expert-stacked form
EXPERT_COUNTS = {"launches": 0, "plain": 0}


def lutq_gemv_packed(x: torch.Tensor, packed: torch.Tensor,
                     d: torch.Tensor) -> torch.Tensor:
    if x.dim() != 2 or packed.dim() != 2 or d.dim() != 1:
        raise ValueError(f"lutq_gemv_packed: want x (M, Kin), packed "
                         f"(Kin/2, N), d (K,); got {tuple(x.shape)}, "
                         f"{tuple(packed.shape)}, {tuple(d.shape)}")
    if packed.shape[0] * 2 != x.shape[1]:
        raise ValueError(f"lutq_gemv_packed: Kin mismatch {tuple(x.shape)} "
                         f"@ packed {tuple(packed.shape)}")
    if packed.dtype != torch.uint8:
        raise TypeError(f"lutq_gemv_packed: packed must be uint8, got "
                        f"{packed.dtype}")
    if d.numel() > 16:
        raise ValueError("lutq_gemv_packed: 4-bit indices address at most "
                         "16 dictionary entries")
    if x.device.type == "cpu":
        COUNTS["plain"] += 1
        return lutq_gemv_packed_ref(x, packed, d)
    y = build.launch_gemm("lutq_gemv_packed_launch", x, packed, d,
                          N=packed.shape[1])
    COUNTS["launches"] += 1
    if audit.RECORDER is not None:  # the weight by its logical (Kin, N)
        audit.note("lutq_gemv_packed", y.dtype, x.shape,
                   (x.shape[1], packed.shape[1]), y.shape)
    return y


def lutq_gemv_packed_experts(x: torch.Tensor, packed: torch.Tensor,
                             d: torch.Tensor) -> torch.Tensor:
    if x.dim() != 3 or packed.dim() != 3 or d.dim() != 2:
        raise ValueError(f"lutq_gemv_packed_experts: want x (E, C, Kin), "
                         f"packed (E, Kin/2, N), d (E, K); got "
                         f"{tuple(x.shape)}, {tuple(packed.shape)}, "
                         f"{tuple(d.shape)}")
    if (packed.shape[0] != x.shape[0] or d.shape[0] != x.shape[0]
            or packed.shape[1] * 2 != x.shape[2]):
        raise ValueError(f"lutq_gemv_packed_experts: shape mismatch "
                         f"{tuple(x.shape)} @ packed {tuple(packed.shape)}, "
                         f"d {tuple(d.shape)}")
    if packed.dtype != torch.uint8:
        raise TypeError(f"lutq_gemv_packed_experts: packed must be uint8, "
                        f"got {packed.dtype}")
    if d.shape[1] > 16:
        raise ValueError("lutq_gemv_packed_experts: 4-bit indices address "
                         "at most 16 dictionary entries")
    if x.device.type == "cpu":
        EXPERT_COUNTS["plain"] += 1
        return lutq_gemv_packed_experts_ref(x, packed, d)
    y = build.launch_gemm("lutq_gemv_packed_launch", x, packed, d,
                          N=packed.shape[2])
    EXPERT_COUNTS["launches"] += 1
    if audit.RECORDER is not None:  # the weight by its logical (Kin, N)
        E, C, Kin = x.shape
        audit.note("lutq_gemv_packed_experts", y.dtype, (E * C, Kin),
                   (Kin, packed.shape[2]), (E * C, packed.shape[2]))
    return y
