"""Build and load the port's CUDA kernels (nvcc + ctypes).

Every ``csrc/*.cu`` is compiled for ``sm_90a`` by its own ``nvcc``
process, all started together, and the objects are linked into one
shared library with a plain C interface. The library lands in
``build/lutq-<hash>/`` at the root of the checkout, keyed by a hash of
the sources and flags, so the first call after a change builds it and
later calls load it. Nothing is built when the module is imported.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List, Optional

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
CFLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                       "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
#: argtypes of the two GEMM launchers: device, x, x_bf16, a, avec, xvec,
#: d, n_dict, y, part, ticket, M, N, Kin, bm, bn, splits, kchunk,
#: experts, stream
LAUNCH_ARGTYPES = [_I, _P, _I, _P, _I, _I, _P, _I, _P, _P, _P, _I, _I, _I,
                   _I, _I, _I, _I, _I, _P]
#: argtypes of the k-means launcher: device, w, head, nvec, tail, chunk,
#: blocks, threads, lanes, slices, d, n_dict, a, part, ticket, sums,
#: counts, stream
KMEANS_ARGTYPES = [_I, _P, _LL, _LL, _LL, _LL, _I, _I, _I, _I, _P, _I, _P,
                   _P, _P, _P, _P, _P]
#: argtypes of the paged-attention launcher: device, q, q dtype, k pool,
#: v pool, pool dtype, k scale, v scale, block, cache_len, out, workspace,
#: partials, tickets, B, Hkv, G, dh, page, NB, window, span, chunk,
#: nsplit, scale, vec, svec, global scores, stream
PAGED_ARGTYPES = [_I, _P, _I, _P, _P, _I, _P, _P, _P, _P, _P, _P, _P, _P,
                  _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, ctypes.c_float,
                  _I, _I, _I, _P]
#: argtypes of the shift-add launcher: device, xq, a, avec, xvec, wsh,
#: n_dict, planes, y, sums, ticket, M, N, Kin, bm, bn, splits, kchunk,
#: experts, stream
SHIFT_ARGTYPES = [_I, _P, _P, _I, _I, _P, _I, _I, _P, _P, _P, _I, _I, _I,
                  _I, _I, _I, _I, _I, _P]
#: argtypes of the flash-attention launcher: device, q, k, v, out, kernel
#: (flash_attn.KERNEL_CODES), BH, S, Skv, D, bk, causal, scale, stream
FLASH_ARGTYPES = [_I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                  ctypes.c_float, _P]
#: every C entry point of the library and its argtypes (all return int)
SIGNATURES = {
    "lutq_matmul_launch": LAUNCH_ARGTYPES,
    "lutq_gemv_packed_launch": LAUNCH_ARGTYPES,
    "lutq_shift_launch": SHIFT_ARGTYPES,
    "kmeans_stats_launch": KMEANS_ARGTYPES,
    "paged_attention_launch": PAGED_ARGTYPES,
    "flash_attention_launch": FLASH_ARGTYPES,
}

_LIB: Optional[ctypes.CDLL] = None
#: {"seconds": build time (0 when loaded from an earlier build),
#:  "path": library path, "ptxas": register/shared-memory report,
#:  "sources": {source: seconds from the start of the build until its
#:  nvcc ended} (only when built)}
BUILD_INFO: Dict[str, object] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: the CUDA kernels are built with "
                           "the CUDA toolkit's nvcc")
    return str(path)


def _digest() -> str:
    h = hashlib.sha256(" ".join(CFLAGS).encode())
    for f in sorted(CSRC.iterdir()):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def _compile(out: Path) -> str:
    """Compile every source in parallel, link into ``out``; return the
    compilers' report."""
    nvcc = _nvcc()
    tmp = out.parent / f"tmp-{os.getpid()}"
    tmp.mkdir(parents=True, exist_ok=True)
    procs = []
    t0 = time.perf_counter()
    for src in sorted(CSRC.glob("*.cu")):
        obj = tmp / (src.stem + ".o")
        log = open(tmp / (src.stem + ".log"), "w+")
        cmd = [nvcc, *CFLAGS, "-c", str(src), "-o", str(obj)]
        procs.append((src.name, cmd, obj, log, subprocess.Popen(
            cmd, stdout=log, stderr=subprocess.STDOUT, text=True)))
    seconds = {}
    while len(seconds) < len(procs):  # each source's own compile time
        for name, _, _, _, proc in procs:
            if name not in seconds and proc.poll() is not None:
                seconds[name] = time.perf_counter() - t0
        time.sleep(0.05)
    BUILD_INFO["sources"] = seconds
    report = []
    for name, cmd, obj, log, proc in procs:
        log.seek(0)
        text = log.read()
        log.close()
        report.append(text)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({' '.join(cmd)}):\n{text}")
    lib_tmp = tmp / out.name
    link = [nvcc, *ARCH_FLAGS, "-shared", "-o", str(lib_tmp),
            *[str(obj) for _, _, obj, _, _ in procs]]
    done = subprocess.run(link, capture_output=True, text=True)
    if done.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{done.stdout}{done.stderr}")
    os.replace(lib_tmp, out)  # atomic: concurrent builders all succeed
    shutil.rmtree(tmp, ignore_errors=True)
    return "".join(report)


def load_library() -> ctypes.CDLL:
    """The kernels' shared library, built on first use."""
    global _LIB
    if _LIB is not None:
        return _LIB
    out = BUILD_ROOT / f"lutq-{_digest()}" / "liblutq.so"
    t0 = time.perf_counter()
    report = ""
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        report = _compile(out)
        (out.parent / "ptxas.txt").write_text(report)
    seconds = time.perf_counter() - t0 if report else 0.0
    lib = ctypes.CDLL(str(out))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    BUILD_INFO.update(seconds=seconds, path=str(out), ptxas=report)
    _LIB = lib
    return lib


# ---------------------------------------------------------------------------
# launching (shared by the two GEMM wrappers)
# ---------------------------------------------------------------------------

BK = 64  # reduction rows of one pipeline stage of the GEMM kernels
#: (largest M, BM, BN, resident blocks an SM, most splits) of the GEMM
#: kernels' output tiles, by M: decode tiles for M <= 16, the mma.sync
#: 64 x 128 prefill tile up to GEMM_STABLE_M rows, the wgmma 128 x 256
#: tile above (None: every larger M). csrc/lutq_gemm.cuh instantiates
#: exactly these tiles and sizes each one's registers for that many
#: blocks an SM; the split plan aims at that many blocks an SM, with at
#: most that many splits (the last block of a tile merges them: a 128 x
#: 256 f32 partial is 128 KB). Measured on the H100: decode at 2 blocks
#: an SM and at most 8 splits beat 1 or 4 blocks and 64 splits at M = 8,
#: and tied at M = 4.
GEMM_TILES = ((8, 8, 256, 2, 8), (16, 16, 256, 2, 8), (256, 64, 128, 2, 8),
              (None, 128, 256, 1, 4))
#: products of at most this many rows split their reduction as an 8-row
#: decode does (the first tile's plan), whatever their tile; this holds
#: for every kernel that plans with :func:`plan_splits` (the shift-add
#: kernel's tiles included). The mma.sync tiles give each output the
#: same chain of products over a split, and the merge sums the splits in
#: order, so such a product's rows are the bits the same rows get in any
#: other product of at most this many rows: a speculative verify window
#: of B (k + 1) rows gives each row the bits of the B-row decode step.
ROW_STABLE_M = 64
#: the LUT-decode GEMMs (``GEMM_TILES``) keep that split, on the mma.sync
#: tiles, up to this many rows, so a paged prefill chunk of up to 256
#: rows gives each row the bits it gets in any narrower chunk: a packed
#: prefill call gives each prompt the rows of its own chunks. (A 128 x
#: 256 wgmma tile at the decode split gives the same rows, measured on
#: the H100, but is slower there.)
GEMM_STABLE_M = 256
#: per device: the output tiles' merge tickets, zero between calls (the
#: kernel's last block of a tile resets its ticket)
_GEMM_TICKETS: Dict[str, torch.Tensor] = {}
#: ticket buffers that a larger one replaced, never freed: a CUDA graph
#: captured before the growth still launches its kernels on them
_OUTGROWN: List[torch.Tensor] = []


def plan_splits(M: int, N: int, Kin: int, sms: int, tiles=GEMM_TILES,
                bk: int = BK, stable_m: int = GEMM_STABLE_M,
                experts: int = 1) -> dict:
    """How a (M, Kin) @ (Kin, N) product is tiled and split, from static
    shapes and the SM count only (never the data).

    The tile follows M (``tiles``: ``GEMM_TILES``, or the shift-add
    kernel's ``lutq_shift.SHIFT_TILES``, in the same form). With fewer
    tiles than the tile's resident blocks an SM times ``sms``, the
    reduction is split, up to the tile's most splits, so that about that
    many blocks run (decode shapes, and prefill of narrow products); each
    split covers ``kchunk`` rows, a multiple of ``bk`` (the kernel's
    rows a pipeline stage). A tile for at most ``stable_m`` rows
    (``GEMM_STABLE_M`` for the GEMMs' tiles; the shift-add kernel passes
    ``ROW_STABLE_M``) takes the split of the first tile over one m tile
    instead, from (N, Kin, sms) alone, so its rows equal the same rows
    of a smaller product bit for bit. ``experts``: an expert-stacked
    call runs that many (M, Kin) @ (Kin, N) products in one launch, so
    its blocks fill the SMs ``experts`` times over before any split.
    Returns bm, bn, grid (m tiles, n tiles, splits), splits, kchunk, and
    the workspace a call needs: ``tickets`` int32 (one a tile of every
    expert) and ``partials`` f32 (experts * splits * M * N), both 0
    without a split.
    """
    top, bm, bn, per_sm, most = next(t for t in tiles
                                     if t[0] is None or M <= t[0])
    grid_m, grid_n = -(-M // bm), -(-N // bn)
    n_tiles = grid_m * grid_n
    steps = -(-Kin // bk)
    fill = n_tiles
    if top is not None and top <= stable_m:
        _, _, bn0, per_sm, most = tiles[0]
        fill = -(-N // bn0)
    want = max(1, min(steps, most, per_sm * sms // (fill * experts)))
    kchunk = -(-steps // want) * bk
    splits = -(-Kin // kchunk)
    split = splits > 1
    return dict(bm=bm, bn=bn, grid=(grid_m, grid_n, splits), splits=splits,
                kchunk=kchunk, tickets=n_tiles * experts if split else 0,
                partials=experts * splits * M * N if split else 0)


def merge_tickets(n: int, device: torch.device) -> torch.Tensor:
    """The device's zeroed merge tickets, at least ``n`` (one a tile),
    shared by every kernel that merges splits: made once and grown
    rarely, since the kernels leave them zero, so a call, or a CUDA graph
    replaying one, needs no reset."""
    return zeroed_tickets(_GEMM_TICKETS, str(device), n, device)


def zeroed_tickets(table: dict, key, n: int, device: torch.device
                   ) -> torch.Tensor:
    """``table[key]``: at least ``n`` zeroed int32 tickets on ``device``,
    made or grown here. A buffer that is grown out is kept, not freed,
    since a graph that captured it replays on it."""
    t = table.get(key)
    if t is None or t.numel() < n:
        if t is not None:
            _OUTGROWN.append(t)
        t = torch.zeros(max(n, 4096), dtype=torch.int32, device=device)
        table[key] = t
    return t


def gemm_workspace(plan: dict, device: torch.device):
    """(partials, tickets) for a call under ``plan``: a fresh f32 buffer
    of ``plan["partials"]`` and the device's zeroed tickets
    (:func:`merge_tickets`); (None, None) without a split."""
    if plan["splits"] == 1:
        return None, None
    part = torch.empty(plan["partials"], dtype=torch.float32, device=device)
    return part, merge_tickets(plan["tickets"], device)


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def launch_gemm(launcher: str, x, a, d, N: int):
    """Run one LUT-decode GEMM launcher (prefill or decode, the plan picks
    the tile) on CUDA tensors; returns y (M, N) f32, or (E, M, N) for an
    expert stack.

    ``a`` is the (Kin, N) int8 or (Kin/2, N) packed assignment matrix
    with x (M, Kin) and d (K,), or an expert stack: x (E, M, Kin), a
    (E, Kin, N) or (E, Kin/2, N), d (E, K), every expert's product in
    the one launch. The kernel copies x and a with 16-byte cp.async
    where their rows are 16-byte aligned, and with plain loads otherwise.
    """
    for name, t in (("x", x), ("a", a), ("d", d)):
        if t.device.type != "cuda":
            raise ValueError(f"{launcher}: {name} is on {t.device}, "
                             f"expected a CUDA tensor")
        if t.device != x.device:
            raise ValueError(f"{launcher}: {name} is on {t.device}, x on "
                             f"{x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{launcher}: {name} must be contiguous")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{launcher}: x must be float32 or bfloat16, got "
                        f"{x.dtype}")
    if d.dtype != torch.float32 or not 1 <= d.shape[-1] <= 256:
        raise TypeError(f"{launcher}: d must be float32 with 1..256 entries")
    E = x.shape[0] if x.dim() == 3 else 1
    M, Kin = x.shape[-2:]
    if M == 0 or N == 0 or Kin == 0 or E == 0:
        raise ValueError(f"{launcher}: empty product {(E, M, Kin, N)}")
    plan = plan_splits(M, N, Kin, sm_count(x.device), experts=E)
    y = torch.empty(tuple(x.shape[:-1]) + (N,), dtype=torch.float32,
                    device=x.device)
    part, ticket = gemm_workspace(plan, x.device)
    avec = int(a.data_ptr() % 16 == 0 and N % 16 == 0)
    xvec = int(x.data_ptr() % 16 == 0 and (Kin * x.element_size()) % 16 == 0)
    fn = getattr(load_library(), launcher)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = fn(x.device.index, x.data_ptr(), int(x.dtype == torch.bfloat16),
            a.data_ptr(), avec, xvec, d.data_ptr(), d.shape[-1],
            y.data_ptr(), None if part is None else part.data_ptr(),
            None if ticket is None else ticket.data_ptr(), M, N, Kin,
            plan["bm"], plan["bn"], plan["splits"], plan["kchunk"], E,
            stream)
    if rc != 0:
        raise RuntimeError(f"{launcher}: CUDA error {rc} at launch "
                           f"(E={E}, M={M}, N={N}, Kin={Kin}, plan={plan})")
    return y
