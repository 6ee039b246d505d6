"""Fused LUT-decode matmul over int8 assignments: ``y = x @ d[A]``.

Counterpart of ``repro.kernels.lutq_matmul`` (the ``fused`` backend of
``kernels.ops.lutq_dot``). On a CUDA tensor it launches the hand-written
CUDA kernel of ``csrc/lutq_matmul.cu`` or raises; on a CPU tensor it runs
the plain version, :func:`repro_torch.kernels.ref.lutq_matmul_ref`.

x (M, Kin) float32/bfloat16; a (Kin, N) int8 (read as unsigned bytes);
d (K <= 256,) float32; y (M, N) float32, any M, N and Kin.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import lutq_matmul_ref

#: launches of the kernel, and calls that ran the plain version instead
COUNTS = {"launches": 0, "plain": 0}


def lutq_matmul(x: torch.Tensor, a: torch.Tensor, d: torch.Tensor
                ) -> torch.Tensor:
    if x.dim() != 2 or a.dim() != 2 or d.dim() != 1:
        raise ValueError(f"lutq_matmul: want x (M, Kin), a (Kin, N), d (K,); "
                         f"got {tuple(x.shape)}, {tuple(a.shape)}, "
                         f"{tuple(d.shape)}")
    if a.shape[0] != x.shape[1]:
        raise ValueError(f"lutq_matmul: Kin mismatch {tuple(x.shape)} @ "
                         f"{tuple(a.shape)}")
    if a.dtype not in (torch.int8, torch.uint8):
        raise TypeError(f"lutq_matmul: a must be int8, got {a.dtype}")
    if x.device.type == "cpu":
        COUNTS["plain"] += 1
        return lutq_matmul_ref(x, a, d)
    y = build.launch_gemm("lutq_matmul_launch", x, a, d, N=a.shape[1],
                          vec_bytes=16)
    COUNTS["launches"] += 1
    return y
