"""k-means step-4 statistics: assignments plus per-entry sums and counts.

Counterpart of ``repro.kernels.kmeans_tpu.kmeans_stats`` (reached
through ``kernels.ops.kmeans_stats``). On a CUDA tensor it launches the
hand-written CUDA kernel of ``csrc/kmeans_stats.cu`` or raises; on a CPU
tensor it runs the plain version,
:func:`repro_torch.kernels.ref.kmeans_stats_ref`.

w: float32, any shape, read as a flat view (no copy when contiguous);
d: (K <= 256,) float32, sorted. Returns (a int8 shaped like w, sums f32
(K,), counts f32 (K,)).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import kmeans_stats_ref

#: launches of the kernel, and calls that ran the plain version instead
COUNTS = {"launches": 0, "plain": 0}


def kmeans_stats(w: torch.Tensor, d: torch.Tensor):
    if w.dtype != torch.float32 or d.dtype != torch.float32:
        raise TypeError(f"kmeans_stats: w and d must be float32, got "
                        f"{w.dtype} and {d.dtype}")
    if d.dim() != 1 or not 1 <= d.numel() <= 256:
        raise ValueError(f"kmeans_stats: d must be (K,) with 1 <= K <= 256, "
                         f"got {tuple(d.shape)}")
    if w.numel() == 0:
        raise ValueError("kmeans_stats: empty w")
    if w.device.type == "cpu":
        COUNTS["plain"] += 1
        a, sums, counts = kmeans_stats_ref(w.reshape(-1), d)
        return a.reshape(w.shape), sums, counts
    for name, t in (("w", w), ("d", d)):
        if t.device.type != "cuda" or t.device != w.device:
            raise ValueError(f"kmeans_stats: {name} is on {t.device}, "
                             f"expected w's CUDA device")
        if not t.is_contiguous():
            raise ValueError(f"kmeans_stats: {name} must be contiguous")
    lib = build.load_library()
    n, K = w.numel(), d.numel()
    blocks = lib.kmeans_stats_blocks(n, K, build.sm_count(w.device))
    a = torch.empty(w.shape, dtype=torch.int8, device=w.device)
    part_sums = torch.empty((blocks, K), dtype=torch.float32, device=w.device)
    part_counts = torch.empty((blocks, K), dtype=torch.int32, device=w.device)
    sums = torch.empty(K, dtype=torch.float32, device=w.device)
    counts = torch.empty(K, dtype=torch.float32, device=w.device)
    stream = torch.cuda.current_stream(w.device).cuda_stream
    rc = lib.kmeans_stats_launch(
        w.device.index, w.data_ptr(), n, d.data_ptr(), K, a.data_ptr(),
        part_sums.data_ptr(), part_counts.data_ptr(), blocks,
        sums.data_ptr(), counts.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"kmeans_stats: CUDA error {rc} at launch "
                           f"(N={n}, K={K}, blocks={blocks})")
    COUNTS["launches"] += 1
    return a, sums, counts
