"""Shift-add LUT matmul of the multiplier-less pow2 path: the exact int32
accumulator ``acc = xq @ wsh[A]``.

Counterpart of ``repro.kernels.lutq_shift`` (the ``pow2`` backend of
``kernels.ops.lutq_dot``). On a CUDA tensor it launches the hand-written
CUDA kernel of ``csrc/lutq_shift.cu`` (int8 tensor-core products on the
digit planes of the shifted dictionary) or raises; on a CPU tensor it
runs the plain version, :func:`repro_torch.kernels.ref.lutq_shift_ref`.

xq (M, Kin) int8 quantized activations; a (Kin, N) int8 assignments
(read as unsigned bytes); wsh (K <= 256,) int32 shifted-integer
dictionary (:func:`repro_torch.kernels.ref.pow2_shift_weights`);
returns (M, N) int32, any M, N and Kin. Integer sums make the result
bit-identical to the plain version under any tiling or split.

:func:`lutq_shift_experts` is the expert-stacked form, the counterpart
of the reference's ``jax.vmap`` of the kernel over a MoE layer's
experts: xq (E, C, Kin), a (E, Kin, N), wsh (E, K) -> (E, C, N) int32,
every expert's product (its own shifted dictionary, split partials and
merge tickets) in ONE launch.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import audit, build
from repro_torch.kernels.ref import (lutq_shift_experts_ref, lutq_shift_ref,
                                     shift_planes)

#: launches of the kernel, and calls that ran the plain version instead
COUNTS = {"launches": 0, "plain": 0}
#: the same for the expert-stacked form
EXPERT_COUNTS = {"launches": 0, "plain": 0}

#: (largest M, BM, BN, resident blocks an SM, most splits) of the
#: kernel's output tiles, by M, in ``build.GEMM_TILES``'s form: decode
#: tiles on mma.sync for M <= 16, wgmma tiles above (128 x 256 up to 128
#: rows, then 256 x 128, which decodes each weight for twice the rows).
#: csrc/lutq_shift.cu instantiates exactly these tiles; each one's 4-stage
#: ring and 32 KB digit table hold one block an SM.
SHIFT_TILES = ((8, 8, 256, 1, 16), (16, 16, 256, 1, 16),
               (128, 128, 256, 1, 4), (None, 256, 128, 1, 4))
#: reduction rows of one pipeline stage (one 128-byte row of xq); a
#: split covers a multiple of them
BK = 128
#: most digit planes the kernel takes (32 bits of |wsh| in 7-bit digits)
MAX_PLANES = 5

def plan_splits(M: int, N: int, Kin: int, sms: int, experts: int = 1
                ) -> dict:
    """The kernel's tile, split and workspace for a (M, Kin) @ (Kin, N)
    product (``experts`` of them, for an expert stack), from static
    shapes and the SM count only:
    :func:`repro_torch.kernels.build.plan_splits` over ``SHIFT_TILES``
    in steps of ``BK`` rows (bm, bn, grid, splits, kchunk, tickets), with
    ``partials`` the int32 partial tiles the splits write (every split's
    whole bm x bn tile, contiguous: experts * tiles * splits * bm * bn; 0
    without a split)."""
    plan = build.plan_splits(M, N, Kin, sms, tiles=SHIFT_TILES, bk=BK,
                             stable_m=build.ROW_STABLE_M, experts=experts)
    grid_m, grid_n, splits = plan["grid"]
    plan["partials"] = (experts * grid_m * grid_n * splits * plan["bm"]
                        * plan["bn"] if splits > 1 else 0)
    return plan


def split_workspace(plan: dict, device: torch.device):
    """(partials, tickets) for a call under ``plan``: a fresh int32 buffer
    of ``plan["partials"]`` and the device's zeroed merge tickets
    (:func:`repro_torch.kernels.build.merge_tickets`); (None, None)
    without a split."""
    if plan["splits"] == 1:
        return None, None
    part = torch.empty(plan["partials"], dtype=torch.int32, device=device)
    return part, build.merge_tickets(plan["tickets"], device)


def _check(name, xq, a, wsh, planes, nd):
    if xq.dim() != nd or a.dim() != nd or wsh.dim() != nd - 1:
        lead = "E, " if nd == 3 else ""
        raise ValueError(f"{name}: want xq ({lead}M, Kin), a ({lead}Kin, N), "
                         f"wsh ({lead}K,); got {tuple(xq.shape)}, "
                         f"{tuple(a.shape)}, {tuple(wsh.shape)}")
    if a.shape[-2] != xq.shape[-1] or a.shape[:-2] != xq.shape[:-2] \
            or wsh.shape[:-1] != xq.shape[:-2]:
        raise ValueError(f"{name}: shape mismatch {tuple(xq.shape)} @ "
                         f"{tuple(a.shape)}, wsh {tuple(wsh.shape)}")
    if xq.dtype != torch.int8:
        raise TypeError(f"{name}: xq must be int8, got {xq.dtype}")
    if a.dtype not in (torch.int8, torch.uint8):
        raise TypeError(f"{name}: a must be int8, got {a.dtype}")
    if wsh.dtype != torch.int32 or not 1 <= wsh.shape[-1] <= 256:
        raise TypeError(f"{name}: wsh must be int32 with 1..256 entries")
    if planes is not None and not 1 <= planes <= MAX_PLANES:
        raise ValueError(f"{name}: planes must be 1..{MAX_PLANES}, got "
                         f"{planes}")


def _launch(name, xq, a, wsh, planes):
    """One launch over xq (M, Kin) or an expert stack (E, M, Kin)."""
    for what, t in (("xq", xq), ("a", a), ("wsh", wsh)):
        if t.device.type != "cuda" or t.device != xq.device:
            raise ValueError(f"{name}: {what} is on {t.device}, expected "
                             f"xq's CUDA device")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {what} must be contiguous")
    E = xq.shape[0] if xq.dim() == 3 else 1
    (M, Kin), N = xq.shape[-2:], a.shape[-1]
    if M == 0 or N == 0 or Kin == 0 or E == 0:
        raise ValueError(f"{name}: empty product {(E, M, Kin, N)}")
    if planes is None:
        planes = shift_planes(wsh)
    plan = plan_splits(M, N, Kin, build.sm_count(xq.device), experts=E)
    y = torch.empty(tuple(xq.shape[:-1]) + (N,), dtype=torch.int32,
                    device=xq.device)
    part, ticket = split_workspace(plan, xq.device)
    avec = int(a.data_ptr() % 16 == 0 and N % 16 == 0)
    xvec = int(xq.data_ptr() % 16 == 0 and Kin % 16 == 0)
    stream = torch.cuda.current_stream(xq.device).cuda_stream
    rc = build.load_library().lutq_shift_launch(
        xq.device.index, xq.data_ptr(), a.data_ptr(), avec, xvec,
        wsh.data_ptr(), wsh.shape[-1], planes, y.data_ptr(),
        None if part is None else part.data_ptr(),
        None if ticket is None else ticket.data_ptr(), M, N, Kin,
        plan["bm"], plan["bn"], plan["splits"], plan["kchunk"], E, stream)
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch (E={E}, "
                           f"M={M}, N={N}, Kin={Kin}, plan={plan})")
    return y


def lutq_shift(xq: torch.Tensor, a: torch.Tensor, wsh: torch.Tensor,
               planes: int = None) -> torch.Tensor:
    """``planes``: the digit planes of ``wsh``
    (:func:`repro_torch.kernels.ref.shift_planes`), which the serving
    path derives once a leaf; derived here (a host read) when None."""
    _check("lutq_shift", xq, a, wsh, planes, 2)
    if xq.device.type == "cpu":
        COUNTS["plain"] += 1
        return lutq_shift_ref(xq, a, wsh)
    y = _launch("lutq_shift", xq, a, wsh, planes)
    COUNTS["launches"] += 1
    if audit.RECORDER is not None:
        M, Kin = xq.shape
        audit.note("lutq_shift", torch.int32, (M, Kin), (Kin, a.shape[1]),
                   y.shape)
    return y


def lutq_shift_experts(xq: torch.Tensor, a: torch.Tensor, wsh: torch.Tensor,
                       planes: int = None) -> torch.Tensor:
    """Expert-stacked :func:`lutq_shift`: ``planes`` covers every
    expert's dictionary (the most any of them needs)."""
    _check("lutq_shift_experts", xq, a, wsh, planes, 3)
    if xq.device.type == "cpu":
        EXPERT_COUNTS["plain"] += 1
        return lutq_shift_experts_ref(xq, a, wsh)
    y = _launch("lutq_shift_experts", xq, a, wsh, planes)
    EXPERT_COUNTS["launches"] += 1
    if audit.RECORDER is not None:
        E, C, Kin = xq.shape  # every expert's rows against one (Kin, N)
        audit.note("lutq_shift_experts", torch.int32, (E * C, Kin),
                   (Kin, a.shape[2]), (E * C, a.shape[2]))
    return y
