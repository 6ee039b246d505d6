#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (src/repro_torch) on one NVIDIA card.

    python3 chip_smoke.py            # from the root of a checkout

Phases, each fatal on failure (nothing here catches a phase's error):

1. setup: the card's name, count and power limit; build the CUDA
   kernels from src/repro_torch/kernels/csrc and print the build time.
2. kernels against their plain versions on the card, at h2o-danube-1.8b
   shapes, bf16 and f32 x, plus a ragged case and (fused) a K=256 case
   with indices >= 128. Error is max|kernel - plain| over max|plain|:
   at most 1e-4 for f32 x (f32 accumulation in another order) and 1e-3
   for bf16 x (tensor-core bf16 products accumulated in f32).
3. serve: full-width h2o-danube-1.8b (24 layers, random weights from a
   seed), 4-bit LUT-Q (QuantSpec(bits=4, min_size=1024)), 8-bit
   activations, batch 4, prompt 128, 16 generated tokens, through
   (a) the packed 4-bit serve view (packed4 kernel) and (b) the int8
   serve view with kernel_backend="fused". Kernel counts are zeroed just
   before each generate and read just after: each forward must launch
   its kernel 7 * 24 + 1 times and run no plain version. Then the
   reduced config served on the card must give the tokens it gives on
   the CPU through the plain versions.
4. timing of each kernel at the decode (M=4) and prefill (M=512) shapes
   with CUDA events, beside its bound, its plain version and a
   torch.matmul on the pre-decoded bf16 weight (a yardstick the port
   never calls).

The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}. Without a card, or outside a checkout,
it exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12        # H100 SXM data sheet
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
L2_BYTES = 50 * 2**20
STEPS_GEN, BATCH, PROMPT = 16, 4, 128
TOL = {"float32": 1e-4, "bfloat16": 1e-3}

# danube's (Kin, N) per layer, with calls per forward, and the head
LAYER_SHAPES = {"q/o": ((2560, 2560), 2), "k/v": ((2560, 640), 2),
                "wi/wg": ((2560, 6912), 2), "wo": ((6912, 2560), 1)}
HEAD_SHAPE = (2560, 32000)
N_LAYERS = 24
CALLS_PER_FORWARD = 7 * N_LAYERS + 1

KERNELS = {
    "lutq_matmul": dict(route="cuda",
                        source="src/repro_torch/kernels/csrc/lutq_matmul.cu",
                        replaces="src/repro/kernels/lutq_matmul.py:52",
                        packed=False),
    "lutq_gemv_packed": dict(
        route="cuda", source="src/repro_torch/kernels/csrc/lutq_gemv_packed.cu",
        replaces="src/repro/kernels/lutq_gemv_packed.py:48", packed=True),
}


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def die(msg: str) -> None:
    print(f"[chip_smoke] FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        die(msg)


# ---------------------------------------------------------------------------
# phase 1
# ---------------------------------------------------------------------------

def setup():
    import torch

    check(torch.cuda.is_available(), "torch.cuda.is_available() is False")
    check((SRC / "repro_torch").is_dir(),
          f"{SRC / 'repro_torch'} not found: run from a checkout")
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    log(f"device {name} x{count} | torch {torch.__version__} cuda "
        f"{torch.version.cuda}")

    from repro_torch.kernels import build

    build.load_library()
    log(f"kernels built in {build.BUILD_INFO['seconds']:.1f} s -> "
        f"{build.BUILD_INFO['path']}")
    for line in str(build.BUILD_INFO["ptxas"]).splitlines():
        if "registers" in line or "spill" in line:
            log(f"  ptxas {line.strip()}")
    return name, count, card


# ---------------------------------------------------------------------------
# phase 2
# ---------------------------------------------------------------------------

def _operands(M, Kin, N, K, dtype, gen, dev, packed):
    import torch

    from repro_torch.kernels.ref import pack4_kin

    x = torch.randn(M, Kin, generator=gen, device=dev).to(dtype)
    lo = -128 if K == 256 else 0
    a = torch.randint(lo, lo + K, (Kin, N), generator=gen, device=dev,
                      dtype=torch.int8)
    d = torch.sort(torch.randn(K, generator=gen, device=dev)).values
    return x, (pack4_kin(a) if packed else a), d


def kernel_checks():
    import torch

    from repro_torch.kernels import lutq_gemv_packed, lutq_matmul
    from repro_torch.kernels.ref import lutq_gemv_packed_ref, lutq_matmul_ref

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    fns = {"lutq_matmul": (lutq_matmul.lutq_matmul, lutq_matmul_ref),
           "lutq_gemv_packed": (lutq_gemv_packed.lutq_gemv_packed,
                                lutq_gemv_packed_ref)}
    shapes = [s for s, _ in LAYER_SHAPES.values()] + [HEAD_SHAPE]
    worst = {}
    for kname, (fn, plain) in fns.items():
        packed = KERNELS[kname]["packed"]
        cases = [(M, Kin, N, 16) for (Kin, N) in shapes
                 for M in ((1, 4, 512) if packed else (4, 512))]
        cases.append((3, 2560, 211, 16))
        if not packed:
            cases.append((4, 2560, 2560, 256))
        worst[kname] = 0.0
        for M, Kin, N, K in cases:
            for dtype in (torch.bfloat16, torch.float32):
                x, a, d = _operands(M, Kin, N, K, dtype, gen, dev, packed)
                got = fn(x, a, d)
                torch.cuda.synchronize()
                want = plain(x, a, d)
                torch.cuda.synchronize()
                err = (got - want).abs().max().item()
                scale = want.abs().max().item()
                dname = str(dtype).split(".")[-1]
                rel = err / max(scale, 1e-30)
                log(f"check {kname} M={M} Kin={Kin} N={N} K={K} {dname}: "
                    f"max_abs_err {err:.3e} rel {rel:.2e} (tol "
                    f"{TOL[dname]:.0e})")
                check(bool(torch.isfinite(got).all()),
                      f"{kname} produced non-finite values")
                check(rel <= TOL[dname], f"{kname} disagrees with its "
                      f"plain version at M={M} Kin={Kin} N={N} {dname}")
                worst[kname] = max(worst[kname], err)
    return worst


# ---------------------------------------------------------------------------
# phase 3
# ---------------------------------------------------------------------------

def _reset_counts():
    from repro_torch.kernels import lutq_gemv_packed, lutq_matmul, ops

    for counts in (lutq_matmul.COUNTS, lutq_gemv_packed.COUNTS, ops.COUNTS):
        for k in counts:
            counts[k] = 0


def _read_counts():
    from repro_torch.kernels import lutq_gemv_packed, lutq_matmul, ops

    return {"lutq_matmul": lutq_matmul.COUNTS["launches"],
            "lutq_gemv_packed": lutq_gemv_packed.COUNTS["launches"],
            "plain": lutq_matmul.COUNTS["plain"]
            + lutq_gemv_packed.COUNTS["plain"],
            "decode": ops.COUNTS["decode"]}


def profile_generate(view, cfg, toks):
    """Device-busy share of one generate, from torch.profiler: the sum of
    kernel device time over the host wall time, and the top kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.runtime.serving import generate

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts, acc_events=True) as prof:
        t0 = time.perf_counter()
        generate(view, cfg, {"tokens": toks}, steps=STEPS_GEN, device="cuda")
        wall_ms = (time.perf_counter() - t0) * 1e3
    # kernel rows only: an aten op's row repeats its kernels' device time
    rows = [(e.self_device_time_total / 1e3, e.count, e.key)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0]
    busy_ms = sum(r[0] for r in rows)
    log(f"  profile: wall {wall_ms:.1f} ms, device busy {busy_ms:.1f} ms "
        f"({busy_ms / wall_ms * 100:.1f}%), idle "
        f"{(1 - busy_ms / wall_ms) * 100:.1f}%")
    for ms, count, key in sorted(rows, reverse=True)[:8]:
        log(f"    {ms:9.3f} ms  x{count:<6d} {key[:90]}")
    return wall_ms, busy_ms


def serve_full_width():
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.policy import backend_manifest, serve_view
    from repro_torch.core.spec import QuantSpec
    from repro_torch.models import api
    from repro_torch.runtime.serving import generate

    cfg = get_config("h2o-danube-1.8b").replace(
        quant=QuantSpec(bits=4, min_size=1024), act_bits=8)
    t0 = time.perf_counter()
    model = api.quantize(api.init(cfg, seed=0, device="cuda"), cfg)
    policy = api.resolved_policy(cfg)
    views = {"lutq_gemv_packed": (serve_view(model, pack4=True,
                                             policy=policy), "auto"),
             "lutq_matmul": (serve_view(model, pack4=False,
                                        policy=policy), "fused")}
    del model  # frees the fp masters
    torch.cuda.synchronize()
    log(f"full-width {cfg.name}: init + quantize + serve views "
        f"{time.perf_counter() - t0:.1f} s")
    gen = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg.vocab, (BATCH, PROMPT), generator=gen)
    launches, tokens, stats_out = {}, {}, {}
    for kname, (view, backend) in views.items():
        run_cfg = cfg.replace(kernel_backend=backend)
        manifest = backend_manifest(view, policy, override=backend)
        want_be = "packed4" if KERNELS[kname]["packed"] else "fused"
        matmul_leaves = [p for p in manifest if p != "embed/table"]
        check(all(manifest[p]["backend"] == want_be for p in matmul_leaves),
              f"{kname} view: not every matmul leaf resolves to {want_be}")
        generate(view, run_cfg, {"tokens": toks}, steps=2,
                 device="cuda")  # warm-up, outside the counted run
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_counts()
        out, stats = generate(view, run_cfg, {"tokens": toks},
                              steps=STEPS_GEN, return_stats=True,
                              device="cuda")
        counts = _read_counts()
        peak = torch.cuda.max_memory_allocated() / 2**30
        expected = STEPS_GEN * CALLS_PER_FORWARD
        other = ("lutq_matmul" if kname == "lutq_gemv_packed"
                 else "lutq_gemv_packed")
        log(f"serve [{want_be}] B={BATCH} P={PROMPT} gen={STEPS_GEN}: "
            f"prefill {stats['t_prefill_s'] * 1e3:.1f} ms | decode "
            f"{stats['decode_tok_s']:.1f} tok/s | peak "
            f"{peak:.2f} GiB | launches {counts}")
        check(counts[kname] == expected, f"{kname}: {counts[kname]} "
              f"launches in the serve run, expected {expected}")
        check(counts[other] == 0 and counts["plain"] == 0
              and counts["decode"] == 0,
              f"{kname} run went through another path: {counts}")
        check(out.shape == (BATCH, STEPS_GEN), f"tokens shape {out.shape}")
        check(bool(((out >= 0) & (out < cfg.vocab)).all()),
              "tokens out of range")
        with torch.inference_mode():
            logits, _ = api.prefill(view, run_cfg, {"tokens": toks.cuda()})
        check(bool(torch.isfinite(logits).all()), "non-finite logits")
        launches[kname] = counts[kname]
        tokens[kname] = out.cpu()
        log(f"  sample tokens {out[0, :8].tolist()}")
        wall_ms, busy_ms = profile_generate(view, run_cfg, toks)
        stats_out[kname] = dict(stats, peak_gib=peak, profiled_wall_ms=wall_ms,
                                profiled_busy_ms=busy_ms)
    same = bool((tokens["lutq_matmul"] == tokens["lutq_gemv_packed"]).all())
    log(f"packed4 and fused runs give the same tokens: {same}")
    del views
    torch.cuda.empty_cache()
    return launches, stats_out


def reduced_reference():
    """The reduced config served on the card agrees with the CPU run
    through the plain versions."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.policy import serve_view
    from repro_torch.core.spec import QuantSpec
    from repro_torch.models import api
    from repro_torch.models.reduce import reduced
    from repro_torch.runtime.serving import generate

    cfg = reduced(get_config("h2o-danube-1.8b")).replace(
        quant=QuantSpec(bits=4, min_size=512), act_bits=32)
    toks = torch.randint(0, cfg.vocab, (2, 30),
                         generator=torch.Generator().manual_seed(2))
    for pack4 in (True, False):
        cpu = serve_view(api.quantize(api.init(cfg, seed=0, device="cpu"),
                                      cfg), pack4=pack4,
                         policy=api.resolved_policy(cfg))
        gpu = serve_view(api.quantize(api.init(cfg, seed=0, device="cpu"),
                                      cfg), pack4=pack4,
                         policy=api.resolved_policy(cfg)).to("cuda")
        with torch.inference_mode():
            lc, _ = api.prefill(cpu, cfg, {"tokens": toks})
            lg, _ = api.prefill(gpu, cfg, {"tokens": toks.cuda()})
        err = (lg.cpu() - lc).abs().max().item() / lc.abs().max().item()
        tc = generate(cpu, cfg, {"tokens": toks}, steps=8, device="cpu")
        tg = generate(gpu, cfg, {"tokens": toks}, steps=8, device="cuda")
        log(f"reduced {cfg.name} pack4={pack4}: card vs cpu logits rel err "
            f"{err:.2e}, tokens equal {bool((tc == tg.cpu()).all())}")
        check(err <= 1e-4, "reduced logits: card and CPU disagree")
        check(bool((tc == tg.cpu()).all()), "reduced tokens differ")


# ---------------------------------------------------------------------------
# phase 4
# ---------------------------------------------------------------------------

def time_ms(fn, arg_sets, iters: int):
    """(device ms, host-loop ms) per call over ``iters`` calls cycling
    through ``arg_sets`` (distinct operand copies, so weights come from
    device memory, not L2, as on the serve path), after a warm-up.

    Device time replays the calls captured in a CUDA graph, so the
    wrapper's host work is out of it; the host-loop time is the same
    calls issued from Python, as the serve path issues them."""
    import torch

    for i in range(3):
        fn(*arg_sets[i % len(arg_sets)])
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(*arg_sets[i % len(arg_sets)])
    end.record()
    torch.cuda.synchronize()
    loop = start.elapsed_time(end) / iters
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            fn(*arg_sets[i % len(arg_sets)])
    graph.replay()
    torch.cuda.synchronize()
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    device = start.elapsed_time(end) / iters
    del graph
    return device, loop


def _copies(nbytes: int) -> int:
    return max(2, min(256, math.ceil(2 * L2_BYTES / max(nbytes, 1))))


def bound(M, Kin, N, packed):
    """(ms for bytes, ms for operations): each input read once, the f32
    output written once, at the HBM rate; bf16 products at the
    tensor-core peak. The bound is the larger of the two."""
    idx_bytes = Kin * N // (2 if packed else 1)
    nbytes = M * Kin * 2 + idx_bytes + 16 * 4 + M * N * 4
    flops = 2 * M * N * Kin
    return (nbytes / HBM_BYTES_PER_S * 1e3,
            flops / PEAK_FLOPS["bfloat16"] * 1e3)


def timings(card: str):
    import torch

    from repro_torch.core.lutq import decode
    from repro_torch.kernels import lutq_gemv_packed, lutq_matmul
    from repro_torch.kernels.ref import (lutq_gemv_packed_ref,
                                         lutq_matmul_ref, unpack4_kin)

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    fns = {"lutq_matmul": (lutq_matmul.lutq_matmul, lutq_matmul_ref),
           "lutq_gemv_packed": (lutq_gemv_packed.lutq_gemv_packed,
                                lutq_gemv_packed_ref)}
    shapes = dict(LAYER_SHAPES, head=(HEAD_SHAPE, 1))
    table = {}
    for kname, (fn, plain) in fns.items():
        packed = KERNELS[kname]["packed"]
        per_m = {}
        for M in (4, 512):
            agg = dict(ms=0.0, loop_ms=0.0, plain_ms=0.0, library_ms=0.0,
                       bytes_ms=0.0, ops_ms=0.0)
            for label, ((Kin, N), calls) in shapes.items():
                x, a, d = _operands(M, Kin, N, 16, torch.bfloat16, gen, dev,
                                    packed)
                n = _copies(a.numel())
                sets = [(x, a.clone(), d) for _ in range(n)]
                t, t_loop = time_ms(fn, sets, iters=max(40, 2 * n))
                tp, _ = time_ms(plain, sets[:2], iters=4)
                w = decode(d, unpack4_kin(a) if packed else a).to(
                    torch.bfloat16)
                nw = _copies(w.numel() * 2)
                wsets = [(x, w.clone()) for _ in range(nw)]
                tl, _ = time_ms(torch.matmul, wsets, iters=max(40, 2 * nw))
                del w, wsets, sets
                tb, to = bound(M, Kin, N, packed)
                b, by = max(tb, to), ("bytes" if tb >= to else "operations")
                log(f"time {kname} M={M} {label} Kin={Kin} N={N}: kernel "
                    f"{t * 1e3:.1f} us (host loop {t_loop * 1e3:.1f} us) | "
                    f"bound {b * 1e3:.1f} us ({by}) = "
                    f"{b / t * 100:.1f}% | plain {tp * 1e3:.1f} us | "
                    f"torch.matmul bf16 {tl * 1e3:.1f} us | {card}")
                per_fwd = calls * (1 if label == "head" else N_LAYERS)
                agg["ms"] += per_fwd * t
                agg["loop_ms"] += per_fwd * t_loop
                agg["plain_ms"] += per_fwd * tp
                agg["library_ms"] += per_fwd * tl
                agg["bytes_ms"] += per_fwd * tb
                agg["ops_ms"] += per_fwd * to
            agg["bound_ms"] = max(agg["bytes_ms"], agg["ops_ms"])
            agg["bound_by"] = ("bytes" if agg["bytes_ms"] >= agg["ops_ms"]
                               else "operations")
            per_m[M] = agg
            log(f"time {kname} M={M} one forward ({CALLS_PER_FORWARD} "
                f"calls): kernel {agg['ms']:.3f} ms (host loop "
                f"{agg['loop_ms']:.3f} ms) | bound "
                f"{agg['bound_ms']:.3f} ms ({agg['bound_by']}) = "
                f"{agg['bound_ms'] / agg['ms'] * 100:.1f}% | plain "
                f"{agg['plain_ms']:.3f} ms | torch.matmul "
                f"{agg['library_ms']:.3f} ms | {card}")
        table[kname] = per_m
    return table


def main() -> int:
    try:
        import torch
    except ImportError:
        die("torch is not importable")
    if not torch.cuda.is_available():
        die("no CUDA device: torch.cuda.is_available() is False")
    t_start = time.perf_counter()
    name, count, card = setup()
    worst = kernel_checks()
    launches, _ = serve_full_width()
    reduced_reference()
    table = timings(card)
    records = []
    for kname, meta in KERNELS.items():
        dec = table[kname][4]
        records.append({
            "name": kname, "route": meta["route"], "source": meta["source"],
            "replaces": meta["replaces"], "launches": launches[kname],
            "max_abs_err": worst[kname],
            # one decode forward at B=4: the 169 calls of the serve path
            "ms": dec["ms"], "plain_ms": dec["plain_ms"],
            "bound_ms": dec["bound_ms"], "bound_by": dec["bound_by"],
            "library_ms": dec["library_ms"]})
    log(f"done in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": records}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
