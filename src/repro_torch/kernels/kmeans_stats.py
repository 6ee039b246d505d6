"""k-means step-4 statistics: assignments plus per-entry sums and counts.

Counterpart of ``repro.kernels.kmeans_tpu.kmeans_stats`` (reached
through ``kernels.ops.kmeans_stats``). On a CUDA tensor it launches the
hand-written CUDA kernel of ``csrc/kmeans_stats.cu`` or raises: one
kernel a call, which merges its blocks' partial rows itself through the
device's shared merge ticket (``build.merge_tickets``). On a CPU tensor
it runs the plain version,
:func:`repro_torch.kernels.ref.kmeans_stats_ref`.

w: float32, any shape, read as a flat view (no copy when contiguous);
d: (K <= 256,) float32, sorted. Returns (a int8 shaped like w, sums f32
(K,), counts f32 (K,)); with ``write_a=False`` a is None and the kernel
writes no assignments (4 B a weight of traffic instead of 5).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import audit, build
from repro_torch.kernels.ref import kmeans_stats_ref

#: launches of the kernel, and calls that ran the plain version instead
COUNTS = {"launches": 0, "plain": 0}

#: float4 vectors a thread takes at least before the grid grows past one
#: block (small leaves run fewer, fuller blocks and merge fewer rows)
MIN_VECS = 8
#: fold lanes an entry and merge slices, at most (csrc kMaxLanes)
MAX_LANES = 16


def threads_for(K: int) -> int:
    """Threads a block for a K-entry dictionary: each thread's private
    (sum, count) columns take T * K * 8 bytes of shared memory (64 KB at
    K = 16 and at K = 256, 32 KB between); K <= 16 runs at 512 threads
    with its midpoints in registers."""
    if K <= 16:
        return 512
    if K <= 32:
        return 128
    if K <= 64:
        return 64
    return 32


def blocks_per_sm(K: int) -> int:
    """Resident blocks an SM the grid aims at: the kernel's launch bounds
    give each thread 64 registers at 2 blocks of 512 threads; K > 128
    takes 64 KB of private columns a block, so 3 fit."""
    return 2 if K <= 16 else 4 if K <= 128 else 3


def _lanes(K: int, T: int) -> int:
    """The largest power of two L <= MAX_LANES with K * L <= T (1 when
    K >= T): the fold's lanes an entry and the merge's row slices."""
    L = 1
    while L < MAX_LANES and K * L * 2 <= T:
        L *= 2
    return L


def plan(n: int, K: int, sms: int, w_offset: int = 0) -> dict:
    """How a call over n weights against a K-entry dictionary is cut,
    from static shapes and the SM count only (never the data).

    ``w_offset`` is w's misalignment in elements mod 4 (its data pointer
    over 4, mod 4). The first ``head`` elements (up to the first 16-byte
    boundary) and the last ``tail`` are scalars; the ``nvec`` float4
    vectors between go to ``blocks`` blocks of ``threads`` threads, block
    b taking vectors [b * chunk, min((b + 1) * chunk, nvec)) (chunk a
    multiple of 32, so that a warp's stores of a fill whole lines; see
    :func:`block_ranges`), thread t of it vectors t, t + threads, ... in
    turn; threads 0 .. head + tail - 1 of block 0 then take the head and
    tail elements. ``rows`` partial rows (one a block) make the workspace;
    ``lanes`` is the fold's lanes an entry and ``slices`` the merge's row
    slices (:func:`repro_torch.kernels.ref.kmeans_stats_order_ref` adds
    in the same order).
    """
    if n < 1 or not 1 <= K <= 256 or sms < 1 or not 0 <= w_offset < 4:
        raise ValueError(f"kmeans_stats.plan: n={n}, K={K}, sms={sms}, "
                         f"w_offset={w_offset}")
    T = threads_for(K)
    head = min((4 - w_offset) % 4, n)
    nvec = (n - head) // 4
    tail = n - head - 4 * nvec
    most = sms * blocks_per_sm(K)
    want = max(1, min(most, -(-nvec // (T * MIN_VECS))))
    # vectors a block, whole warps' lines: 32 float4s of w, 128 bytes of a
    chunk = -(-nvec // (want * 32)) * 32
    blocks = -(-nvec // chunk) if nvec else 1
    lanes = _lanes(K, T)
    return dict(threads=T, blocks=blocks, chunk=chunk, head=head, nvec=nvec,
                tail=tail, rows=blocks, lanes=lanes, slices=lanes)


def block_ranges(p: dict):
    """Each block's [begin, end) of the plan's float4 vectors."""
    return [(b * p["chunk"], min(p["nvec"], (b + 1) * p["chunk"]))
            for b in range(p["blocks"])]


def kmeans_stats(w: torch.Tensor, d: torch.Tensor, write_a: bool = True):
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
        a, sums, counts = kmeans_stats_ref(w.reshape(-1), d, write_a)
        return (None if a is None else a.reshape(w.shape)), sums, counts
    for name, t in (("w", w), ("d", d)):
        if t.device.type != "cuda" or t.device != w.device:
            raise ValueError(f"kmeans_stats: {name} is on {t.device}, "
                             f"expected w's CUDA device")
        if not t.is_contiguous():
            raise ValueError(f"kmeans_stats: {name} must be contiguous")
    lib = build.load_library()
    n, K, dev = w.numel(), d.numel(), w.device
    offset = (w.data_ptr() // 4) % 4
    p = plan(n, K, build.sm_count(dev), offset)
    a = None
    if write_a:  # at w's misalignment: a + head is 4-byte aligned
        a = torch.empty(n + offset, dtype=torch.int8,
                        device=dev)[offset:].view(w.shape)
    part = torch.empty((p["rows"], K, 2), dtype=torch.float32, device=dev)
    sums = torch.empty(K, dtype=torch.float32, device=dev)
    counts = torch.empty(K, dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.kmeans_stats_launch(
        dev.index, w.data_ptr(), p["head"], p["nvec"], p["tail"], p["chunk"],
        p["blocks"], p["threads"], p["lanes"], p["slices"], d.data_ptr(), K,
        None if a is None else a.data_ptr(), part.data_ptr(),
        build.merge_tickets(1, dev).data_ptr(), sums.data_ptr(),
        counts.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"kmeans_stats: CUDA error {rc} at launch "
                           f"(N={n}, K={K}, plan={p})")
    COUNTS["launches"] += 1
    if audit.RECORDER is not None:  # a reduction, no product
        audit.note("kmeans_stats", torch.float32, None, None, (K, 2))
    return a, sums, counts
