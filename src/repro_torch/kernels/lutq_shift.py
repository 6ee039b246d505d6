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
"""
from __future__ import annotations

import torch

from repro_torch.kernels import audit, build
from repro_torch.kernels.ref import lutq_shift_ref, shift_planes

#: launches of the kernel, and calls that ran the plain version instead
COUNTS = {"launches": 0, "plain": 0}

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

def plan_splits(M: int, N: int, Kin: int, sms: int) -> dict:
    """The kernel's tile, split and workspace for a (M, Kin) @ (Kin, N)
    product, from static shapes and the SM count only:
    :func:`repro_torch.kernels.build.plan_splits` over ``SHIFT_TILES``
    in steps of ``BK`` rows (bm, bn, grid, splits, kchunk, tickets), with
    ``partials`` the int32 partial tiles the splits write (every split's
    whole bm x bn tile, contiguous: tiles * splits * bm * bn; 0 without a
    split)."""
    plan = build.plan_splits(M, N, Kin, sms, tiles=SHIFT_TILES, bk=BK,
                             stable_m=build.ROW_STABLE_M)
    grid_m, grid_n, splits = plan["grid"]
    plan["partials"] = (grid_m * grid_n * splits * plan["bm"] * plan["bn"]
                        if splits > 1 else 0)
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


def lutq_shift(xq: torch.Tensor, a: torch.Tensor, wsh: torch.Tensor,
               planes: int = None) -> torch.Tensor:
    """``planes``: the digit planes of ``wsh``
    (:func:`repro_torch.kernels.ref.shift_planes`), which the serving
    path derives once a leaf; derived here (a host read) when None."""
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
    if planes is not None and not 1 <= planes <= MAX_PLANES:
        raise ValueError(f"lutq_shift: planes must be 1..{MAX_PLANES}, got "
                         f"{planes}")
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
    if planes is None:
        planes = shift_planes(wsh)
    plan = plan_splits(M, N, Kin, build.sm_count(xq.device))
    y = torch.empty((M, N), dtype=torch.int32, device=xq.device)
    part, ticket = split_workspace(plan, xq.device)
    avec = int(a.data_ptr() % 16 == 0 and N % 16 == 0)
    xvec = int(xq.data_ptr() % 16 == 0 and Kin % 16 == 0)
    stream = torch.cuda.current_stream(xq.device).cuda_stream
    rc = build.load_library().lutq_shift_launch(
        xq.device.index, xq.data_ptr(), a.data_ptr(), avec, xvec,
        wsh.data_ptr(), wsh.numel(), planes, y.data_ptr(),
        None if part is None else part.data_ptr(),
        None if ticket is None else ticket.data_ptr(), M, N, Kin,
        plan["bm"], plan["bn"], plan["splits"], plan["kchunk"], stream)
    if rc != 0:
        raise RuntimeError(f"lutq_shift: CUDA error {rc} at launch (M={M}, "
                           f"N={N}, Kin={Kin}, plan={plan})")
    COUNTS["launches"] += 1
    if audit.RECORDER is not None:
        audit.note("lutq_shift", torch.int32, (M, Kin), (Kin, N), (M, N))
    return y
