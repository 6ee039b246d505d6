"""Serving CLI: LUT-Q weights served as a static batch or through the
continuous-batching engine (slot pool or paged KV).

Counterpart of ``repro.launch.serve`` without the mesh and autotune
options. On the card:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch h2o-danube-1.8b \
        --batch 4 --prompt-len 128 --gen 16 --pack4
    PYTHONPATH=src python -m repro_torch.launch.serve --arch h2o-danube-1.8b \
        --engine --kv-pages 160 --page-size 64 --max-batch 8 --queue 16 \
        --prompt-len 512 --gen 64 --pack4

    PYTHONPATH=src python -m repro_torch.launch.serve --arch h2o-danube-1.8b \
        --quant-policy serving_pow2 --batch 4 --prompt-len 128 --gen 16
    PYTHONPATH=src python -m repro_torch.launch.serve --arch h2o-danube-1.8b \
        --act-bits 32 --speculative 3 --draft-bits 3 --batch 4 \
        --prompt-len 128 --gen 32 --pack4
    PYTHONPATH=src python -m repro_torch.launch.serve --arch h2o-danube-1.8b \
        --ckpt-dir DIR --pack4

The MoE family (qwen3-moe-235b-a22b: experts through the expert-stacked
kernels, one launch a product; an --engine with --kv-pages serves it
through its slot pool, as the reference does):

    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch qwen3-moe-235b-a22b --batch 4 --prompt-len 128 --gen 16

The encoder-decoder family (seamless-m4t-medium: ``frames`` of the
prompt's width, standard normal from ``--seed``, stand in for the audio
frontend; an --engine takes sources of up to --prompt-len frames):

    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch seamless-m4t-medium --batch 4 --prompt-len 128 --gen 16

The vlm family (paligemma-3b: a prefix of the config's 256 image
embeddings a row, standard normal from ``--seed``, stands in for the
SigLIP frontend; an --engine draws one a request and mixes in no
text-only requests, as ``synthetic_requests`` does; it serves through
its slot pool, as the reference does):

    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch paligemma-3b --batch 4 --prompt-len 128 --gen 16

The hybrid family (zamba2-2.7b: Mamba2 layers whose state a decode step
overwrites in place, one shared attention block every 6 layers; an
--engine prefills one prompt length a group and serves through its slot
pool, as the reference does):

    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch zamba2-2.7b --batch 4 --prompt-len 128 --gen 16

The ssm family (rwkv6-1.6b: attention-free RWKV6 layers whose WKV state
and token-shift rows a decode step overwrites in place, an f32 residual
stream, a tied 65536-row readout; an --engine prefills one prompt length
a group and serves through its slot pool, as the reference does):

    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch rwkv6-1.6b --batch 4 --prompt-len 128 --gen 16 \
        [--pack4 | --quant-policy serving_pow2 | --engine | --ckpt-dir DIR]

On the CPU, through the kernels' plain versions, at the reduced size:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch h2o-danube-1.8b \
        --reduced --batch 2 --prompt-len 16 --gen 8 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch h2o-danube-1.8b \
        --reduced --quant-policy serving_pow2 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch qwen3-moe-235b-a22b --reduced --device cpu [--engine]
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch seamless-m4t-medium --reduced --device cpu [--engine \
        --kv-pages 24 --page-size 16]
    PYTHONPATH=src python -m repro_torch.launch.serve --arch paligemma-3b \
        --reduced --device cpu [--pack4 | --engine]
    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-2.7b \
        --reduced --device cpu [--engine] [--pack4]
    PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-1.6b \
        --reduced --device cpu [--engine] [--pack4 | --quant-policy \
        serving_pow2]
    PYTHONPATH=src python -m repro_torch.launch.serve --arch h2o-danube-1.8b \
        --reduced --engine --kv-pages 24 --page-size 16 --max-batch 2 \
        --queue 4 --prompt-len 30 --gen 8 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch h2o-danube-1.8b \
        --reduced --act-bits 32 --speculative 2 --draft-bits 2 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --arch h2o-danube-1.8b \
        --reduced --steps 3 --batch 4 --seq 32 --device cpu --ckpt-dir DIR
    PYTHONPATH=src python -m repro_torch.launch.serve --arch h2o-danube-1.8b \
        --reduced --vocab 256 --device cpu --ckpt-dir DIR

``--ckpt-dir`` serves the (d, A) that ``launch/train.py`` trained: the
latest train checkpoint's parameters, memory-mapped
(``ckpt.restore_params``; the optimizer moments are never read), loaded
without their masters (``interop.from_train_params``), with the
manifest's quant policy in place of the ``--quant-*`` flags; a
checkpoint that does not fit ``--arch`` / ``--reduced`` / ``--vocab``
is refused (the train CLI's vocab defaults to 256, this one's to the
config's). Otherwise the weights are random, from ``--seed``.

Serves the paper's deployment form (serve_view: dictionary + int8 or
packed assignments, no fp masters; under ``serving_pow2`` pow2
dictionaries as int8 sign+exponent planes through the shift-add kernel,
with activation scales taken per call, as the reference CLI serves it
without calibration), reports the weight footprint both ways, the
per-rule breakdown, the backend of each quantized leaf and how many are
pow2-encoded, the prefill time and decode rate (with ``--engine``:
goodput, latency and TTFT percentiles, and the paged cache's pages and
prefix hits), and how many times each kernel launched. With
``--speculative K`` (which needs ``--act-bits 32``) each decode step is a
self-speculative round: a ``--draft-bits`` view of the same indices
drafts K tokens, one target window checks them; it also reports the
acceptance and the draft view's extra bytes.
"""
from __future__ import annotations

import argparse
import sys
from collections import Counter

import torch

from repro_torch import interop
from repro_torch.checkpoint import ckpt
from repro_torch.configs import get_config, list_archs
from repro_torch.core.policy import (backend_manifest, effective_bits,
                                     format_breakdown, quantized_fraction,
                                     rule_breakdown, serve_view)
from repro_torch.core.rules import get_policy
from repro_torch.core.spec import QuantSpec
from repro_torch.device import resolve_device
from repro_torch.core.lutq import LutqState
from repro_torch.kernels import (lutq_gemv_packed, lutq_matmul, lutq_shift,
                                 paged_attn)
from repro_torch.kernels.ops import BACKENDS
from repro_torch.models import api
from repro_torch.models.reduce import reduced
from repro_torch.nn.tree import tree_paths
from repro_torch.runtime.engine import Engine, synthetic_requests
from repro_torch.runtime.serving import generate


def footprint_bytes(model) -> int:
    total = 0
    for _, leaf in tree_paths(model):
        for t in (leaf if isinstance(leaf, tuple) else (leaf,)):
            if t is not None:
                total += t.numel() * t.element_size()
    return total


def check_ckpt_shapes(cfg, trainable) -> None:
    """Refuse a restored train checkpoint that does not fit the serve
    config, naming the mismatched leaves (a vocab or width mismatch
    would otherwise serve garbage): every leaf of the checkpoint's
    ``trainable`` tree against the shapes ``cfg`` gives
    (:func:`repro_torch.interop.trainable_shapes`). Raises SystemExit."""
    want = interop.trainable_shapes(cfg)
    got = {path: getattr(leaf, "shape", None)
           for path, leaf in interop.walk(trainable)}
    bad = []
    for path in sorted(set(want) | set(got)):
        key = "/".join(path)
        if path not in got:
            bad.append(f"{key}: missing from checkpoint")
        elif path not in want:
            bad.append(f"{key}: not in model")
        elif tuple(got[path] or ()) != want[path]:
            bad.append(f"{key}: model {want[path]} vs checkpoint "
                       f"{got[path]}")
    if bad:
        raise SystemExit(
            "[serve] checkpoint does not fit the serve config "
            f"({len(bad)} mismatched leaves, e.g. {bad[:3]}). "
            "--arch/--reduced/--vocab (and the quant policy, when the "
            "manifest lacks one) must match the training run.")


def kernel_report(dev: torch.device, experts: bool = False) -> str:
    """The kernels' launches and the plain versions' calls; with
    ``experts`` (a MoE config) also the expert-stacked kernels'."""
    name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
    stacked = (lutq_matmul, lutq_gemv_packed, lutq_shift)
    plain = sum(m.COUNTS["plain"] for m in stacked + (paged_attn,))
    plain += sum(m.EXPERT_COUNTS["plain"] for m in stacked)
    moe = ""
    if experts:
        moe = ", " + ", ".join(
            f"{m.__name__.rsplit('.', 1)[-1]}_experts "
            f"{m.EXPERT_COUNTS['launches']}" for m in stacked)
    return (f"[serve] kernel launches: lutq_matmul "
            f"{lutq_matmul.COUNTS['launches']}, lutq_gemv_packed "
            f"{lutq_gemv_packed.COUNTS['launches']}, lutq_shift "
            f"{lutq_shift.COUNTS['launches']}, paged_attention "
            f"{paged_attn.COUNTS['launches']}{moe} | plain versions: "
            f"{plain} | device {name}")


def run_engine(model, cfg, *, capacity: int, n_requests: int,
               prompt_len: int, gen: int, seed: int = 0,
               temperature: float = 0.0, kv_pages=None, page_size: int = 64,
               prefix_cache: bool = True, requests=None,
               speculative: int = 0, draft_bits: int = 3, draft_params=None,
               device="cuda"):
    """Serve a ragged queue through the continuous-batching engine and
    return its stats dict (the CLI's and the smoke test's fields).

    ``kv_pages`` switches onto the paged KV cache. ``requests``
    overrides the synthetic workload with a list of ``Engine.submit``
    kwargs dicts. ``speculative``: draft block length of self-speculative
    rounds (the cache gets that much headroom). An encdec engine takes
    sources of up to ``prompt_len`` frames, as the reference's CLI."""
    src_len = prompt_len if cfg.family == "encdec" else 0
    eng = Engine(model, cfg, capacity=capacity,
                 max_len=prompt_len + gen + int(speculative),
                 src_len=src_len, temperature=temperature, seed=seed, kv_pages=kv_pages,
                 page_size=page_size, prefix_cache=prefix_cache,
                 speculative=speculative,
                 draft_bits=draft_bits, draft_params=draft_params,
                 device=device)
    if requests is None:
        requests = synthetic_requests(cfg, n_requests, max_prompt=prompt_len,
                                      max_new=gen, seed=seed,
                                      src_len=src_len)
    for req in requests:
        req = dict(req)
        req.pop("arrival_s", None)
        eng.submit(**req)
    eng.run()
    return eng.stats()


def format_engine_stats(stats) -> str:
    out = (f"[serve] engine: {stats['completed']}/{stats['admitted']} requests "
           f"on {stats['capacity']} slots | decode[{stats['backend']}]: "
           f"{stats['decode_tok_s']:.1f} tok/s | goodput "
           f"{stats['goodput_tok_s']:.1f} tok/s | latency p50 "
           f"{stats['p50_latency_s']*1e3:.0f} ms p95 "
           f"{stats['p95_latency_s']*1e3:.0f} ms | ttft p50 "
           f"{stats['ttft_p50_s']*1e3:.0f} ms p99 "
           f"{stats['ttft_p99_s']*1e3:.0f} ms | "
           f"{stats['decode_steps']} decode steps, "
           f"prefill {stats['t_prefill_s']:.2f} s, "
           f"decode {stats['t_decode_s']:.2f} s, "
           f"warmup {stats['t_warmup_s']:.2f} s")
    if "src_len" in stats:
        out += f" | sources up to {stats['src_len']} frames"
    if stats.get("paged"):
        out += (f"\n[serve] paged KV: {stats['pages_in_use']}/"
                f"{stats['kv_pages'] - 1} pages in use "
                f"(peak {stats['pages_peak']}) x {stats['page_size']} tokens"
                f" | {stats['kv_bytes_per_token']} KV bytes/token"
                f" | {stats['prefill_chunk_calls']} prefill calls, "
                f"{stats['packed_groups']} packed groups of "
                f"{stats['packed_requests']} requests")
        if "prefix_hit_rate" in stats:
            out += (f" | prefix cache: {stats['prefix_hits']}/"
                    f"{stats['prefix_queries']} page hits "
                    f"({stats['prefix_hit_rate']*100:.0f}%), "
                    f"{stats['prefix_evictions']} evictions")
    if stats.get("speculative_k"):
        out += "\n" + format_spec_stats(stats)
    return out


def format_spec_stats(stats) -> str:
    """The speculative line: k, draft bits, acceptance, tokens a round and
    the draft view's extra bytes."""
    out = (f"[serve] speculative: k={stats['speculative_k']} "
           f"draft_bits={stats['draft_bits']} | acceptance "
           f"{stats['acceptance_rate']*100:.0f}% | "
           f"{stats['spec_tokens_per_round']:.2f} tok/round | "
           f"{stats['spec_rounds']} rounds")
    if "draft_extra_bytes" in stats:
        out += (f" | draft view +{stats['draft_extra_bytes']/2**20:.2f} "
                f"MiB ({stats['draft_coarse_leaves']} coarse, "
                f"{stats['draft_shared_leaves']} shared leaves)")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=list_archs())
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--quant-policy", default=None,
                    help="mixed-precision policy: preset name, "
                         "'uniform:<bits>[:<constraint>]', inline JSON, or "
                         "@policy.json; supersedes --quant-bits")
    ap.add_argument("--quant-bits", type=int, default=4)
    ap.add_argument("--pack4", action="store_true",
                    help="pack two 4-bit assignments per byte (K<=16 leaves)")
    ap.add_argument("--kernel-backend", default="auto", choices=list(BACKENDS),
                    help="kernel path for quantized matmuls: auto resolves "
                         "per leaf (int8 -> fused, packed -> packed4); "
                         "decode forces the dense-materialize path; "
                         "packed4 implies --pack4")
    ap.add_argument("--engine", action="store_true",
                    help="serve a ragged FIFO queue through the "
                         "continuous-batching engine instead of one static "
                         "batch")
    ap.add_argument("--max-batch", type=int, default=4,
                    help="engine slot-pool capacity (decode batch width)")
    ap.add_argument("--queue", type=int, default=16,
                    help="number of ragged requests to enqueue with --engine")
    ap.add_argument("--kv-pages", type=int, default=None,
                    help="serve through the paged KV cache with this many "
                         "pool pages (block-table slots, prefix sharing, "
                         "chunked prefill)")
    ap.add_argument("--page-size", type=int, default=64,
                    help="tokens per KV page (power of two)")
    ap.add_argument("--prefix-cache", default=True,
                    action=argparse.BooleanOptionalAction,
                    help="share identical prompt-prefix pages across "
                         "requests (--no-prefix-cache disables)")
    ap.add_argument("--act-bits", type=int, default=8, choices=(8, 32),
                    help="activation fake-quant bits (32 disables; "
                         "required for --speculative)")
    ap.add_argument("--speculative", type=int, default=0, metavar="K",
                    help="self-speculative decoding: draft K tokens a round "
                         "from a coarse view of the same LUT-Q indices, "
                         "check them with one target forward (greedy "
                         "tokens unchanged; needs --act-bits 32: dynamic "
                         "activation quantization couples the rows)")
    ap.add_argument("--draft-bits", type=int, default=3,
                    help="draft view dictionary size = 2^draft_bits entries "
                         "a leaf (leaves already at or below it are shared "
                         "with the target)")
    ap.add_argument("--ckpt-dir", default=None,
                    help="serve the (d, A) trained by launch/train.py: the "
                         "latest train checkpoint's parameters (the "
                         "manifest's quant policy supersedes the --quant "
                         "flags) instead of random weights from --seed")
    ap.add_argument("--vocab", type=int, default=None,
                    help="override the vocab size (0 or unset keeps the "
                         "config's; must match the checkpoint's with "
                         "--ckpt-dir)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where to run; cuda raises when no card is found")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    if args.vocab:
        cfg = cfg.replace(vocab=args.vocab)
    ckpt_policy = ckpt.load_policy(args.ckpt_dir) if args.ckpt_dir else None
    if ckpt_policy is not None:
        quant = ckpt_policy
    elif args.quant_policy:
        quant = get_policy(args.quant_policy)
    else:
        quant = QuantSpec(bits=args.quant_bits, min_size=1024)
    cfg = cfg.replace(quant=quant, act_bits=args.act_bits,
                      kernel_backend=args.kernel_backend)
    if args.speculative:
        ok, why = api.speculative_supported(cfg)
        if not ok:
            raise SystemExit(f"[serve] --speculative refused: {why}")

    policy = api.resolved_policy(cfg)
    pack = args.pack4 or args.kernel_backend == "packed4"
    if args.ckpt_dir:
        params, step = ckpt.restore_params(args.ckpt_dir)
        check_ckpt_shapes(cfg, params["trainable"])
        fp_bytes = sum(leaf.nbytes for _, leaf in
                       interop.walk(params["trainable"]) if leaf is not None)
        qmodel = interop.from_train_params(params, cfg, pack4=pack,
                                           policy=policy, device=dev)
        print(f"[serve] restored train checkpoint step {step} from "
              f"{args.ckpt_dir}"
              + (" (policy from manifest)" if ckpt_policy is not None else ""))
        if ckpt_policy is not None:
            print(ckpt_policy.describe())
    else:
        model = api.init(cfg, seed=args.seed, device=dev)
        fp_bytes = footprint_bytes(model)
        qmodel = api.quantize(model, cfg)
        del model
    smodel = serve_view(qmodel, pack4=pack, policy=policy)
    del qmodel  # the fp masters go with the quantized tree
    manifest = backend_manifest(smodel, policy, override=args.kernel_backend)

    q_bytes = footprint_bytes(smodel)
    print(f"[serve] {cfg.name}: weights fp32 {fp_bytes/2**20:.2f} MiB -> "
          f"LUT-Q {q_bytes/2**20:.2f} MiB ({fp_bytes/max(q_bytes,1):.2f}x) | "
          f"quantized {quantized_fraction(smodel)*100:.1f}% of params "
          f"@ {effective_bits(smodel):.2f} effective bits")
    print(format_breakdown(rule_breakdown(smodel, policy)))
    counts = Counter(m["backend"] for m in manifest.values())
    print(f"[serve] kernel backends (requested {args.kernel_backend!r}): "
          + ", ".join(f"{k}: {v} leaves" for k, v in sorted(counts.items())))
    states = [x for _, x in tree_paths(smodel) if isinstance(x, LutqState)]
    n_pow2 = sum(x.d.dtype == torch.int8 for x in states)
    if n_pow2 or any(m["requested"] == "pow2" for m in manifest.values()):
        frozen = all(x.act is not None for x in states)
        print(f"[serve] pow2-encoded leaves: {n_pow2} of {len(states)} "
              f"(activation scales {'frozen' if frozen else 'per call'})")

    if args.engine:
        stats = run_engine(smodel, cfg, capacity=args.max_batch,
                           n_requests=args.queue, prompt_len=args.prompt_len,
                           gen=args.gen, seed=args.seed,
                           kv_pages=args.kv_pages, page_size=args.page_size,
                           prefix_cache=args.prefix_cache,
                           speculative=args.speculative,
                           draft_bits=args.draft_bits, device=dev)
        print(format_engine_stats(stats))
        print(kernel_report(dev, bool(cfg.n_experts)))
        return 0

    B, P = args.batch, args.prompt_len
    gen = torch.Generator().manual_seed(args.seed + 1)
    toks = torch.randint(0, cfg.vocab, (B, P), generator=gen)
    batch = {"tokens": toks}
    src = ""
    if cfg.family == "encdec":
        batch["frames"] = torch.randn(
            (B, P, cfg.d_model), generator=torch.Generator().manual_seed(
                args.seed + 2)).to(cfg.dtype)
        src = f" over {P} source frames"
    if cfg.family == "vlm":
        batch["prefix_embeds"] = torch.randn(
            (B, cfg.n_prefix_tokens, cfg.d_model),
            generator=torch.Generator().manual_seed(args.seed + 3)).to(
                cfg.dtype)
        src = f" after a {cfg.n_prefix_tokens}-token image prefix"
    out, stats = generate(smodel, cfg, batch, steps=args.gen,
                          return_stats=True, speculative=args.speculative,
                          draft_bits=args.draft_bits, device=dev)
    print(f"[serve] prefill {P} toks x{B}{src}: "
          f"{stats['t_prefill_s']*1e3:.1f} ms | "
          f"decode[{stats['backend']}]: {stats['decode_tok_s']:.1f} tok/s | "
          f"warmup {stats['t_warmup_s'] * 1e3:.1f} ms | "
          f"sample: {out[0, :8].tolist()}")
    if args.speculative:
        print(format_spec_stats(stats))
    print(kernel_report(dev, bool(cfg.n_experts)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
