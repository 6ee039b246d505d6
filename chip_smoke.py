#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (src/repro_torch) on one NVIDIA card.

    python3 chip_smoke.py            # from the root of a checkout

Phases, each fatal on failure (nothing here catches a phase's error):

1. setup: the card's name, count and power limit; build the CUDA
   kernels from src/repro_torch/kernels/csrc and print the build time.
2. kernels against their plain versions on the card, at h2o-danube-1.8b
   shapes. The GEMMs: bf16 and f32 x, plus a ragged case and (fused) a
   K=256 case with indices >= 128; error is max|kernel - plain| over
   max|plain|: at most 1e-4 for f32 x (f32 accumulation in another
   order) and 1e-3 for bf16 x (tensor-core bf16 products accumulated in
   f32). kmeans_stats: every leaf shape of the model with a 4-bit pow2
   dictionary (K=16) and with K=256, a ragged N and a dictionary whose
   midpoints are weights; assignments equal byte for byte, counts
   exactly equal, each entry's sum within 1e-5 of sum|w| over the entry
   (f32 in another order).
3. serve: full-width h2o-danube-1.8b (24 layers, random weights from a
   seed), 4-bit LUT-Q (QuantSpec(bits=4, min_size=1024)), 8-bit
   activations, batch 4, prompt 128, 16 generated tokens, through
   (a) the packed 4-bit serve view (packed4 kernel) and (b) the int8
   serve view with kernel_backend="fused". Kernel counts are zeroed just
   before each generate and read just after: each forward must launch
   its kernel 7 * 24 + 1 times and run no plain version. Then the
   reduced config served on the card must give the tokens it gives on
   the CPU through the plain versions.
3b. train: full-width h2o-danube-1.8b (vocab 32000, random f32 masters
   from a seed) through the training CLI's build path and TrainLoop,
   with its default spec (4-bit pow2, kmeans_iters=1, min_size=4096)
   and 8-bit activations, B=4, S=512, 3 steps of AdamW. Each step must
   launch kmeans_stats (kmeans_iters + 1) x (quantized leaves) times
   and run no plain version; losses finite; afterwards every dictionary
   sorted with power-of-two nonzero entries and the masters moved. One
   more step is profiled (device-idle share, kmeans_stats share). Then
   the reduced config trains 3 steps on the card and on the CPU from
   the same initial state and batches with kmeans_impl="stats": losses
   within 1e-4 relative, dictionaries within 1e-5.
4. timing of each GEMM kernel at the decode (M=4) and prefill (M=512)
   shapes with CUDA events, beside its bound, its plain version and a
   torch.matmul on the pre-decoded bf16 weight (a yardstick the port
   never calls); kmeans_stats over every leaf shape of one training
   step (two passes), beside its byte bound and its plain version (no
   single PyTorch call computes what it does).

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

# danube's quantized leaves (rows, cols) with their count in one model
TRAIN_LEAVES = {"q/o": ((2560, 2560), 2 * N_LAYERS),
                "k/v": ((2560, 640), 2 * N_LAYERS),
                "wi/wg": ((2560, 6912), 2 * N_LAYERS),
                "wo": ((6912, 2560), N_LAYERS),
                "embed/head": ((32000, 2560), 2)}
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ = 3, 4, 512
KMEANS_SUM_TOL = 1e-5  # of sum|w| over the entry

KERNELS = {
    "lutq_matmul": dict(route="cuda",
                        source="src/repro_torch/kernels/csrc/lutq_matmul.cu",
                        replaces="src/repro/kernels/lutq_matmul.py:52",
                        packed=False),
    "lutq_gemv_packed": dict(
        route="cuda", source="src/repro_torch/kernels/csrc/lutq_gemv_packed.cu",
        replaces="src/repro/kernels/lutq_gemv_packed.py:48", packed=True),
    "kmeans_stats": dict(
        route="cuda", source="src/repro_torch/kernels/csrc/kmeans_stats.cu",
        replaces="src/repro/kernels/kmeans_tpu.py:51"),
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


def _pow2_dict(w, K):
    """A sorted 4-bit pow2 dictionary fit to w, as the training spec's
    init makes it (K=16), or a sorted random one (other K)."""
    import torch

    from repro_torch.core.lutq import init_dictionary
    from repro_torch.core.spec import QuantSpec

    if K == 16:
        return init_dictionary(w[: 1 << 20], QuantSpec(bits=4,
                                                       constraint="pow2"))
    g = torch.Generator(device=w.device).manual_seed(K)
    return torch.sort(torch.randn(K, generator=g, device=w.device)
                      * w.std()).values


def kmeans_checks():
    """kmeans_stats against its plain version; returns the largest
    |sums - plain sums| seen."""
    import torch

    from repro_torch.kernels.kmeans_stats import kmeans_stats
    from repro_torch.kernels.ref import kmeans_stats_ref

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(4)
    cases = [(r * c, K, False) for (r, c), _ in TRAIN_LEAVES.values()
             for K in (16, 256)]
    cases += [(1_000_003, 16, False), (1_000_003, 256, False),
              (4_000_037, 16, True), (1_000_003, 256, True)]
    worst = 0.0
    for N, K, ties in cases:
        w = torch.randn(N, generator=gen, device=dev) * 0.02
        if ties:  # every midpoint of d is a weight, many times over
            d = torch.arange(K, dtype=torch.float32, device=dev) - (K - 1) / 2
            w = (torch.randint(0, 2 * K, (N,), generator=gen, device=dev)
                 - K) * 0.5
        else:
            d = _pow2_dict(w, K)
        a, sums, counts = kmeans_stats(w, d)
        torch.cuda.synchronize()
        a0, s0, c0 = kmeans_stats_ref(w, d)
        torch.cuda.synchronize()
        idx = a0.view(torch.uint8).long()
        mag = torch.zeros(K, dtype=torch.float64, device=dev).index_add_(
            0, idx, w.abs().double()).float()
        err = (sums - s0).abs()
        rel = (err / mag.clamp(min=1e-30)).max().item()
        n_bad = int((a != a0).sum())
        on_mid = int(torch.isin(w, (d[:-1] + d[1:]) * 0.5).sum())
        log(f"check kmeans_stats N={N} K={K}: {on_mid} weights on a "
            f"midpoint, assignments differing {n_bad}, counts equal "
            f"{bool(torch.equal(counts, c0))}, sums max err "
            f"{err.max().item():.3e} ({rel:.2e} of sum|w|, tol "
            f"{KMEANS_SUM_TOL:.0e})")
        check(n_bad == 0, f"kmeans_stats assignments differ at N={N} K={K}")
        check(bool(torch.equal(counts, c0)), f"kmeans_stats counts differ "
              f"at N={N} K={K}")
        check(bool((err <= KMEANS_SUM_TOL * mag).all()),
              f"kmeans_stats sums off at N={N} K={K}")
        if K == 256:
            check(bool((a < 0).any()), "K=256: no index >= 128 seen")
        worst = max(worst, err.max().item())
        del w, a, a0
    return worst


# ---------------------------------------------------------------------------
# phase 3
# ---------------------------------------------------------------------------

def _count_dicts():
    from repro_torch.kernels import (kmeans_stats, lutq_gemv_packed,
                                     lutq_matmul, ops)

    return (lutq_matmul.COUNTS, lutq_gemv_packed.COUNTS, kmeans_stats.COUNTS,
            ops.COUNTS)


def _reset_counts():
    for counts in _count_dicts():
        for k in counts:
            counts[k] = 0


def _read_counts():
    mm, gp, km, ops = _count_dicts()
    return {"lutq_matmul": mm["launches"], "lutq_gemv_packed": gp["launches"],
            "kmeans_stats": km["launches"],
            "plain": mm["plain"] + gp["plain"] + km["plain"],
            "decode": ops["decode"]}


def profile_run(fn, what: str):
    """Device-busy share of ``fn()`` (which ends in a synchronize), from
    torch.profiler: the sum of kernel device time over the host wall
    time. Returns (wall ms, busy ms, [(ms, count, kernel name)])."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts, acc_events=True) as prof:
        t0 = time.perf_counter()
        fn()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # kernel rows only: an aten op's row repeats its kernels' device time
    rows = [(e.self_device_time_total / 1e3, e.count, e.key)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0]
    busy_ms = sum(r[0] for r in rows)
    check(busy_ms > 0, f"profile of {what}: no device time recorded")
    log(f"  profile {what}: wall {wall_ms:.1f} ms, device busy "
        f"{busy_ms:.1f} ms ({busy_ms / wall_ms * 100:.1f}%), idle "
        f"{(1 - busy_ms / wall_ms) * 100:.1f}%")
    for ms, count, key in sorted(rows, reverse=True)[:8]:
        log(f"    {ms:9.3f} ms  x{count:<6d} {key[:90]}")
    return wall_ms, busy_ms, rows


def profile_generate(view, cfg, toks):
    import torch

    from repro_torch.runtime.serving import generate

    def run():
        generate(view, cfg, {"tokens": toks}, steps=STEPS_GEN, device="cuda")
        torch.cuda.synchronize()
    wall_ms, busy_ms, _ = profile_run(run, "generate")
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
# phase 3b
# ---------------------------------------------------------------------------

def _train_args(*flags):
    import torch

    from repro_torch.launch import train as train_cli

    args = train_cli.parser().parse_args(["--arch", "h2o-danube-1.8b",
                                          *flags])
    args.device = torch.device(args.device)
    return args


def _leaves(model):
    from repro_torch.nn.tree import QuantKernel

    return [(n, m) for n, m in model.named_modules()
            if isinstance(m, QuantKernel)]


def train_full_width():
    """Full-width danube trained 3 steps through the CLI's build path and
    TrainLoop; returns the phase's numbers."""
    import torch

    from repro_torch.data.synthetic import MarkovLM
    from repro_torch.kernels import kmeans_stats
    from repro_torch.launch import train as train_cli
    from repro_torch.models import api
    from repro_torch.runtime.loop import TrainLoop

    args = _train_args("--steps", str(TRAIN_STEPS), "--batch",
                       str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ),
                       "--vocab", "0", "--device", "cuda")
    t0 = time.perf_counter()
    cfg, state, step_fn = train_cli.build(args)
    torch.cuda.synchronize()
    check((cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_ff,
           cfg.vocab) == (N_LAYERS, 2560, 32, 8, 6912, 32000),
          f"not full-width danube: {cfg}")
    spec = cfg.quant
    leaves = _leaves(state.model)
    n_leaves = len(leaves)
    per_step = (spec.kmeans_iters + 1) * n_leaves
    log(f"train {cfg.name}: init + quantize {time.perf_counter() - t0:.1f} s"
        f" | {n_leaves} quantized leaves | spec bits={spec.bits} "
        f"{spec.constraint} kmeans_iters={spec.kmeans_iters} | act_bits "
        f"{cfg.act_bits} | B={args.batch} S={args.seq} | remat {cfg.remat}")
    check(n_leaves == 7 * N_LAYERS + 2, f"{n_leaves} quantized leaves")
    watch = {n: m.w.detach().clone() for n, m in
             (leaves[0], leaves[n_leaves // 2], leaves[-1])}
    lm = MarkovLM(cfg.vocab, seed=args.data_seed)
    launches = []

    def counted_step(st, batch):
        before = kmeans_stats.COUNTS["launches"]
        out = step_fn(st, batch)
        launches.append(kmeans_stats.COUNTS["launches"] - before)
        return out

    loop = TrainLoop(counted_step, train_cli.batch_fn(lm, args, args.device),
                     log_every=1, log_fn=log,
                     quant_policy=api.resolved_policy(cfg))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    state, step = loop.run(state, TRAIN_STEPS, handle_signals=False)
    counts = _read_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    check(step == TRAIN_STEPS, f"trained {step} steps")
    ms = [h["dt"] * 1e3 for h in loop.history]
    losses = [h["loss"] for h in loop.history]
    tok_s = [TRAIN_BATCH * TRAIN_SEQ / (t / 1e3) for t in ms]
    log(f"train steps: ms {['%.1f' % t for t in ms]} | tokens/s "
        f"{['%.0f' % t for t in tok_s]} | loss {['%.4f' % x for x in losses]}"
        f" | grad_norm {['%.3f' % h['grad_norm'] for h in loop.history]} | "
        f"peak {peak:.2f} GiB | launches {counts} per step {launches}")
    check(all(math.isfinite(x) for x in losses), f"loss not finite: {losses}")
    check(launches == [per_step] * TRAIN_STEPS,
          f"kmeans_stats launched {launches} per step, expected {per_step}")
    check(counts["plain"] == 0, f"a plain version ran: {counts}")
    check(counts["lutq_matmul"] == 0 and counts["lutq_gemv_packed"] == 0,
          f"train-form leaves reached a serve kernel: {counts}")
    for name, mod in leaves:
        d = mod.d
        check(bool((d[1:] >= d[:-1]).all()), f"{name}: dictionary unsorted")
        mant, _ = torch.frexp(d[d != 0])
        check(bool((mant.abs() == 0.5).all()),
              f"{name}: a dictionary entry is not a power of two: {d}")
    moved = {n: float((dict(leaves)[n].w.detach() - w0).abs().max())
             for n, w0 in watch.items()}
    log(f"masters moved (max |w - w0|): {moved}")
    check(all(v > 0 for v in moved.values()), "the masters did not move")

    batch = loop.make_batch(TRAIN_STEPS)

    def one_step():
        step_fn(state, batch)
        torch.cuda.synchronize()
    wall, busy, rows = profile_run(one_step, "one training step")
    km_ms = sum(r[0] for r in rows if "kmeans" in r[2])
    log(f"  kmeans_stats in the profiled step: {km_ms:.2f} ms = "
        f"{km_ms / wall * 100:.2f}% of the step, "
        f"{km_ms / busy * 100:.2f}% of device time")
    out = dict(launches=counts["kmeans_stats"], n_leaves=n_leaves,
               per_step=per_step, ms=ms, tok_s=tok_s, peak_gib=peak,
               idle=1 - busy / wall, kmeans_share=km_ms / wall)
    del state, loop, step_fn, watch
    torch.cuda.empty_cache()
    return out


def reduced_train_card_vs_cpu():
    """The reduced config trained 3 steps on the card and on the CPU from
    one initial state and the same batches, kmeans_impl="stats" forced.
    Activations stay f32 here: the point is the kernel path, and an
    8-bit activation grid turns a one-ulp matmul difference into a
    ~1e-5 loss difference."""
    import torch

    from repro_torch.data.synthetic import MarkovLM
    from repro_torch.launch import train as train_cli

    args = _train_args("--reduced", "--steps", "3", "--batch", "4",
                       "--seq", "32", "--act-bits", "32", "--device", "cpu")
    runs = {}
    for dev in ("cpu", "cuda"):
        cfg, state, step_fn = train_cli.build(args, kmeans_impl="stats")
        state.model.to(dev)
        state.opt_state = {k: {n: t.to(dev) for n, t in v.items()}
                           for k, v in state.opt_state.items()}
        make_batch = train_cli.batch_fn(MarkovLM(cfg.vocab, seed=0), args,
                                        torch.device(dev))
        _reset_counts()
        losses = []
        for s in range(3):
            state, m = step_fn(state, make_batch(s))
            losses.append(float(m["loss"]))
        runs[dev] = (losses, {n: m.d.cpu() for n, m in _leaves(state.model)},
                     _read_counts())
    n_leaves = len(runs["cpu"][1])
    want = 3 * 2 * n_leaves
    (lc, dc, cc), (lg, dg, cg) = runs["cpu"], runs["cuda"]
    rel = max(abs(a - b) / abs(a) for a, b in zip(lc, lg))
    derr = max(float((dg[n] - dc[n]).abs().max() / dc[n].abs().max())
               for n in dc)
    log(f"reduced train card vs cpu: losses {lg} vs {lc} (max rel "
        f"{rel:.2e}), dictionaries max rel {derr:.2e} | card {cg} | cpu {cc}")
    check(cg["kmeans_stats"] == want and cg["plain"] == 0,
          f"card run: {cg}, expected {want} kmeans_stats launches")
    check(cc["kmeans_stats"] == 0 and cc["plain"] == want,
          f"cpu run: {cc}, expected {want} plain passes")
    check(rel <= 1e-4, "reduced training: card and CPU losses disagree")
    check(derr <= 1e-5, "reduced training: dictionaries disagree")


# ---------------------------------------------------------------------------
# phase 4
# ---------------------------------------------------------------------------

def time_ms(fn, arg_sets, iters: int, graph: bool = True):
    """(device ms, host-loop ms) per call over ``iters`` calls cycling
    through ``arg_sets`` (distinct operand copies, so weights come from
    device memory, not L2, as on the serve path), after a warm-up.

    Device time replays the calls captured in a CUDA graph, so the
    wrapper's host work is out of it; the host-loop time is the same
    calls made from Python, as the serve path makes them. With
    ``graph=False`` (a function that synchronizes, such as the k-means
    plain version's ``bincount``) both are the host-loop time."""
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
    if not graph:
        return loop, loop
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


def kmeans_timings(card: str):
    """kmeans_stats over every leaf shape of one training step (two
    passes each), against its byte bound: each pass reads 4 B of w and
    writes 1 B of a per weight, plus the (K,) dictionary in and sums and
    counts out. The work per weight (an 8-step binary search and two
    adds) is far below the f32 rate, so bytes bound it."""
    import torch

    from repro_torch.kernels.kmeans_stats import kmeans_stats
    from repro_torch.kernels.ref import kmeans_stats_ref

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    agg = dict(ms=0.0, loop_ms=0.0, plain_ms=0.0, bytes_ms=0.0, ops_ms=0.0)
    passes = 2  # kmeans_iters = 1, plus the final assignment
    for label, ((r, c), count) in TRAIN_LEAVES.items():
        N = r * c
        w = torch.randn(N, generator=gen, device=dev) * 0.02
        d = _pow2_dict(w, 16)
        n = _copies(N * 4)
        sets = [(w.clone(), d) for _ in range(n)]
        t, t_loop = time_ms(kmeans_stats, sets, iters=max(20, 2 * n))
        tp, _ = time_ms(kmeans_stats_ref, sets[:2], iters=4, graph=False)
        tb = (N * 5 + 16 * 4 * 3) / HBM_BYTES_PER_S * 1e3
        to = N * 6 / PEAK_FLOPS["float32"] * 1e3
        log(f"time kmeans_stats {label} N={N}: kernel {t * 1e3:.1f} us "
            f"(host loop {t_loop * 1e3:.1f} us) | bound {tb * 1e3:.1f} us "
            f"(bytes) = {tb / t * 100:.1f}% | plain {tp * 1e3:.1f} us | "
            f"{card}")
        k = passes * count
        agg["ms"] += k * t
        agg["loop_ms"] += k * t_loop
        agg["plain_ms"] += k * tp
        agg["bytes_ms"] += k * tb
        agg["ops_ms"] += k * to
        del sets, w
    agg["bound_ms"] = max(agg["bytes_ms"], agg["ops_ms"])
    agg["bound_by"] = "bytes" if agg["bytes_ms"] >= agg["ops_ms"] else \
        "operations"
    n_calls = passes * sum(c for _, c in TRAIN_LEAVES.values())
    log(f"time kmeans_stats one training step ({n_calls} calls): kernel "
        f"{agg['ms']:.3f} ms (host loop {agg['loop_ms']:.3f} ms) | bound "
        f"{agg['bound_ms']:.3f} ms ({agg['bound_by']}) = "
        f"{agg['bound_ms'] / agg['ms'] * 100:.1f}% | plain "
        f"{agg['plain_ms']:.3f} ms | library: none | {card}")
    return agg


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
    worst["kmeans_stats"] = kmeans_checks()
    launches, _ = serve_full_width()
    reduced_reference()
    trained = train_full_width()
    launches["kmeans_stats"] = trained["launches"]
    reduced_train_card_vs_cpu()
    table = {k: v[4] for k, v in timings(card).items()}
    table["kmeans_stats"] = dict(kmeans_timings(card), library_ms=None)
    records = []
    for kname, meta in KERNELS.items():
        t = table[kname]
        records.append({
            "name": kname, "route": meta["route"], "source": meta["source"],
            "replaces": meta["replaces"], "launches": launches[kname],
            "max_abs_err": worst[kname],
            # GEMMs: one decode forward at B=4, the 169 calls of the serve
            # path; kmeans_stats: one training step, its 340 calls
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"]})
    log(f"done in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": records}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
