"""Serving CLI: batched prefill + greedy decode with LUT-Q weights.

Counterpart of ``repro.launch.serve`` without the engine, mesh,
checkpoint, autotune and speculative options. On the card:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch h2o-danube-1.8b \
        --batch 4 --prompt-len 128 --gen 16 --pack4

On the CPU, through the kernels' plain versions, at the reduced size:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch h2o-danube-1.8b \
        --reduced --batch 2 --prompt-len 16 --gen 8 --device cpu

Serves the paper's deployment form (serve_view: dictionary + int8 or
packed assignments, no fp masters), reports the weight footprint both
ways, the per-rule breakdown, the backend of each quantized leaf, the
prefill time and decode rate, and how many times each kernel launched.
"""
from __future__ import annotations

import argparse
import sys
from collections import Counter

import torch

from repro_torch.configs import get_config, list_archs
from repro_torch.core.policy import (backend_manifest, effective_bits,
                                     format_breakdown, quantized_fraction,
                                     rule_breakdown, serve_view)
from repro_torch.core.rules import get_policy
from repro_torch.core.spec import QuantSpec
from repro_torch.device import resolve_device
from repro_torch.kernels import lutq_gemv_packed, lutq_matmul
from repro_torch.kernels.ops import BACKENDS
from repro_torch.models import api
from repro_torch.models.reduce import reduced
from repro_torch.nn.tree import tree_paths
from repro_torch.runtime.serving import generate


def footprint_bytes(model) -> int:
    total = 0
    for _, leaf in tree_paths(model):
        for t in (leaf if isinstance(leaf, tuple) else (leaf,)):
            if t is not None:
                total += t.numel() * t.element_size()
    return total


def kernel_report(dev: torch.device) -> str:
    name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
    return (f"[serve] kernel launches: lutq_matmul "
            f"{lutq_matmul.COUNTS['launches']}, lutq_gemv_packed "
            f"{lutq_gemv_packed.COUNTS['launches']} | plain versions: "
            f"{lutq_matmul.COUNTS['plain'] + lutq_gemv_packed.COUNTS['plain']}"
            f" | device {name}")


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
    ap.add_argument("--act-bits", type=int, default=8, choices=(8, 32),
                    help="activation fake-quant bits (32 disables)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where to run; cuda raises when no card is found")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    quant = (get_policy(args.quant_policy) if args.quant_policy
             else QuantSpec(bits=args.quant_bits, min_size=1024))
    cfg = cfg.replace(quant=quant, act_bits=args.act_bits,
                      kernel_backend=args.kernel_backend)

    model = api.init(cfg, seed=args.seed, device=dev)
    fp_bytes = footprint_bytes(model)
    qmodel = api.quantize(model, cfg)
    policy = api.resolved_policy(cfg)
    pack = args.pack4 or args.kernel_backend == "packed4"
    smodel = serve_view(qmodel, pack4=pack, policy=policy)
    del model, qmodel  # the fp masters go with the quantized tree
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

    B, P = args.batch, args.prompt_len
    gen = torch.Generator().manual_seed(args.seed + 1)
    toks = torch.randint(0, cfg.vocab, (B, P), generator=gen)
    out, stats = generate(smodel, cfg, {"tokens": toks}, steps=args.gen,
                          max_len=P + args.gen, return_stats=True,
                          device=dev)
    print(f"[serve] prefill {P} toks x{B}: {stats['t_prefill_s']*1e3:.1f} ms | "
          f"decode[{stats['backend']}]: {stats['decode_tok_s']:.1f} tok/s | "
          f"sample: {out[0, :8].tolist()}")
    print(kernel_report(dev))
    return 0


if __name__ == "__main__":
    sys.exit(main())
