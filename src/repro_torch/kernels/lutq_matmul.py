"""Fused LUT-decode matmul over int8 assignments: ``y = x @ d[A]``.

Counterpart of ``repro.kernels.lutq_matmul`` (the ``fused`` backend of
``kernels.ops.lutq_dot``). On a CUDA tensor it launches the hand-written
CUDA kernel of ``csrc/lutq_matmul.cu`` or raises; on a CPU tensor it runs
the plain version, :func:`repro_torch.kernels.ref.lutq_matmul_ref`.

x (M, Kin) float32/bfloat16; a (Kin, N) int8 (read as unsigned bytes);
d (K <= 256,) float32; y (M, N) float32, any M, N and Kin.

:func:`lutq_matmul_experts` is the expert-stacked form, the counterpart
of the reference's ``jax.vmap`` of this kernel over a MoE layer's
experts: x (E, C, Kin), a (E, Kin, N), d (E, K) -> y (E, C, N), every
expert's product, with its own dictionary, in ONE launch (a grid
dimension selects the expert).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import audit, build
from repro_torch.kernels.ref import lutq_matmul_experts_ref, lutq_matmul_ref

#: launches of the kernel, and calls that ran the plain version instead
COUNTS = {"launches": 0, "plain": 0}
#: the same for the expert-stacked form
EXPERT_COUNTS = {"launches": 0, "plain": 0}


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
    y = build.launch_gemm("lutq_matmul_launch", x, a, d, N=a.shape[1])
    COUNTS["launches"] += 1
    if audit.RECORDER is not None:
        audit.note("lutq_matmul", y.dtype, x.shape, a.shape, y.shape)
    return y


def lutq_matmul_experts(x: torch.Tensor, a: torch.Tensor, d: torch.Tensor
                        ) -> torch.Tensor:
    if x.dim() != 3 or a.dim() != 3 or d.dim() != 2:
        raise ValueError(f"lutq_matmul_experts: want x (E, C, Kin), a (E, "
                         f"Kin, N), d (E, K); got {tuple(x.shape)}, "
                         f"{tuple(a.shape)}, {tuple(d.shape)}")
    if (a.shape[0] != x.shape[0] or d.shape[0] != x.shape[0]
            or a.shape[1] != x.shape[2]):
        raise ValueError(f"lutq_matmul_experts: shape mismatch "
                         f"{tuple(x.shape)} @ {tuple(a.shape)}, d "
                         f"{tuple(d.shape)}")
    if a.dtype not in (torch.int8, torch.uint8):
        raise TypeError(f"lutq_matmul_experts: a must be int8, got {a.dtype}")
    if x.device.type == "cpu":
        EXPERT_COUNTS["plain"] += 1
        return lutq_matmul_experts_ref(x, a, d)
    y = build.launch_gemm("lutq_matmul_launch", x, a, d, N=a.shape[2])
    EXPERT_COUNTS["launches"] += 1
    if audit.RECORDER is not None:
        E, C, Kin = x.shape  # every expert's rows against one (Kin, N)
        audit.note("lutq_matmul_experts", y.dtype, (E * C, Kin),
                   (Kin, a.shape[2]), (E * C, a.shape[2]))
    return y
