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
from typing import Dict, Optional

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
CFLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                       "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
#: argtypes of the two GEMM launchers: device, x, x_bf16, a, vec, d,
#: n_dict, y, part, M, N, Kin, splits, kchunk, stream
LAUNCH_ARGTYPES = [_I, _P, _I, _P, _I, _P, _I, _P, _P, _I, _I, _I, _I, _I,
                   _P]
#: argtypes of the k-means launcher: device, w, n, d, n_dict, a,
#: part_sums, part_counts, blocks, sums, counts, stream
KMEANS_ARGTYPES = [_I, _P, _LL, _P, _I, _P, _P, _P, _I, _P, _P, _P]
#: every C entry point of the library and its argtypes (all return int)
SIGNATURES = {
    "lutq_matmul_launch": LAUNCH_ARGTYPES,
    "lutq_gemv_packed_launch": LAUNCH_ARGTYPES,
    "kmeans_stats_launch": KMEANS_ARGTYPES,
    "kmeans_stats_blocks": [_LL, _I, _I],  # n, n_dict, SMs -> grid size
}

_LIB: Optional[ctypes.CDLL] = None
#: {"seconds": build time (0 when loaded from an earlier build),
#:  "path": library path, "ptxas": register/shared-memory report}
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
    for src in sorted(CSRC.glob("*.cu")):
        obj = tmp / (src.stem + ".o")
        cmd = [nvcc, *CFLAGS, "-c", str(src), "-o", str(obj)]
        procs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    report = []
    for cmd, obj, proc in procs:
        text, _ = proc.communicate()
        report.append(text)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({' '.join(cmd)}):\n{text}")
    lib_tmp = tmp / out.name
    link = [nvcc, *ARCH_FLAGS, "-shared", "-o", str(lib_tmp),
            *[str(obj) for _, obj, _ in procs]]
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

BN, BK = 128, 32  # the kernels' output-column and reduction tiles


def plan_splits(M: int, N: int, Kin: int, sms: int):
    """(splits, kchunk): reduction split for a (M, N, Kin) product.

    With fewer output tiles than SMs (decode shapes) the reduction is
    split so that about two blocks per SM read assignments; each split
    covers ``kchunk`` rows, a multiple of the kernels' 32-row step.
    """
    bm = 16 if M <= 16 else 64
    tiles = -(-N // BN) * -(-M // bm)
    steps = -(-Kin // BK)
    if tiles >= sms:
        return 1, steps * BK
    want = min(steps, -(-2 * sms // tiles))
    kchunk = -(-steps // want) * BK
    return -(-Kin // kchunk), kchunk


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def launch_gemm(launcher: str, x, a, d, N: int, vec_bytes: int):
    """Run one decode-GEMM launcher on CUDA tensors; returns y (M, N) f32.

    ``a`` is the (Kin, N) int8 or (Kin/2, N) packed assignment matrix;
    the launcher reads it with ``vec_bytes``-wide loads where alignment
    allows.
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
    if d.dtype != torch.float32 or not 1 <= d.numel() <= 256:
        raise TypeError(f"{launcher}: d must be float32 with 1..256 entries")
    M, Kin = x.shape
    if M == 0 or N == 0 or Kin == 0:
        raise ValueError(f"{launcher}: empty product {(M, Kin, N)}")
    splits, kchunk = plan_splits(M, N, Kin, sm_count(x.device))
    y = torch.empty((M, N), dtype=torch.float32, device=x.device)
    part = (torch.empty((splits, M, N), dtype=torch.float32, device=x.device)
            if splits > 1 else None)
    vec = int(a.data_ptr() % vec_bytes == 0 and N % vec_bytes == 0)
    fn = getattr(load_library(), launcher)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = fn(x.device.index, x.data_ptr(), int(x.dtype == torch.bfloat16),
            a.data_ptr(), vec, d.data_ptr(), d.numel(), y.data_ptr(),
            None if part is None else part.data_ptr(), M, N, Kin, splits,
            kchunk, stream)
    if rc != 0:
        raise RuntimeError(f"{launcher}: CUDA error {rc} at launch "
                           f"(M={M}, N={N}, Kin={Kin}, splits={splits})")
    return y
