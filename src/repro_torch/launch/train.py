"""Training CLI (counterpart of ``repro.launch.train``).

On the card:

    PYTHONPATH=src python -m repro_torch.launch.train --arch h2o-danube-1.8b \
        --steps 3 --batch 4 --seq 512 --vocab 0

On the CPU, through the kernels' plain versions, at the reduced size:

    PYTHONPATH=src python -m repro_torch.launch.train --arch h2o-danube-1.8b \
        --reduced --steps 12 --batch 4 --seq 32 --device cpu --ckpt-dir /tmp/ckpt

Same flags and defaults as the reference: a 4-bit pow2 LUT-Q spec
(``kmeans_iters=1``, ``min_size=4096``), 8-bit activations, AdamW on a
cosine schedule, MarkovLM batches, vocab 256 unless ``--vocab`` says
otherwise (0 keeps the config's). A vlm config (paligemma-3b) trains
on prefixed batches: each step's batch carries ``prefix_embeds`` (B, P,
D), standard normal from a torch generator seeded by ``--data-seed``
and the step, in place of the stubbed image frontend's output; torch
cannot draw the reference's ``jax.random`` numbers, so the prefixes
differ from the reference CLI's (the tokens are the same MarkovLM
batches). The loss drops the prefix's logits. An encdec config
(seamless-m4t-medium) trains on batches that carry ``frames`` (B, S,
d_model), the stubbed audio frontend's output, drawn the same way
(:func:`frames_seed`). The hybrid (zamba2-2.7b) and ssm (rwkv6-1.6b)
configs train on the plain batches. ``--mesh``,
``--grad-compress`` and ``--autotune`` other than ``off`` are not
ported yet and raise. The
checkpoints are the reference's format, so either package resumes the
other's.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from repro_torch.configs import get_config, list_archs
from repro_torch.core.rules import get_policy
from repro_torch.core.spec import QuantSpec
from repro_torch.data.synthetic import MarkovLM
from repro_torch.device import resolve_device
from repro_torch.kernels import kmeans_stats
from repro_torch.models import api
from repro_torch.models.reduce import reduced
from repro_torch.optim.optimizers import adamw, cosine_schedule
from repro_torch.optim.train_state import init_train_state, make_train_step
from repro_torch.runtime.loop import TrainLoop


def _train_cfg(args):
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    if args.quant_policy:
        policy = get_policy(args.quant_policy)
        cfg = cfg.replace(quant=policy, act_bits=args.act_bits)
        print(policy.describe())
    elif args.quant_bits > 0:
        cfg = cfg.replace(quant=QuantSpec(bits=args.quant_bits,
                                          constraint=args.quant_constraint,
                                          kmeans_iters=1,
                                          min_size=args.quant_min_size),
                          act_bits=args.act_bits)
    else:
        cfg = cfg.replace(quant=None, act_bits=32)
    if args.vocab:
        cfg = cfg.replace(vocab=args.vocab)
    return cfg


def build(args, *, kmeans_impl=None):
    """(cfg, state, step_fn) for one training run on ``args.device``.

    ``kmeans_impl`` forces the step-4 implementation (see
    ``repro_torch.core.lutq.resolve_kmeans_impl``); None is structural.
    """
    if args.mesh:
        raise NotImplementedError("--mesh is not ported yet: multi-GPU "
                                  "training, ROADMAP queue 1, multi-GPU")
    if args.grad_compress:
        raise NotImplementedError("--grad-compress is not ported yet: "
                                  "ROADMAP queue 1, multi-GPU")
    if args.autotune != "off":
        raise NotImplementedError("--autotune is not ported yet: ROADMAP "
                                  "queue 1, tuning and benches")
    cfg = _train_cfg(args)
    model = api.quantize(api.init(cfg, seed=args.seed, device=args.device),
                         cfg)
    opt = adamw(cosine_schedule(args.lr, args.warmup, args.steps))
    state = init_train_state(model, opt)
    step_fn = make_train_step(cfg, api.loss_fn, opt,
                              microbatches=args.microbatches,
                              kmeans_impl=kmeans_impl)
    return cfg, state, step_fn


def prefix_seed(data_seed: int, step: int) -> int:
    """The seed of step ``step``'s vlm prefix generator."""
    return int(np.random.SeedSequence([data_seed, step, 8]).generate_state(
        1)[0])


def frames_seed(data_seed: int, step: int) -> int:
    """The seed of step ``step``'s encdec frames generator."""
    return int(np.random.SeedSequence([data_seed, step, 7]).generate_state(
        1)[0])


def _normal(seed: int, shape, cfg, device) -> torch.Tensor:
    """Standard normal ``shape`` from a CPU generator seeded by ``seed``,
    in ``cfg.dtype`` on ``device``."""
    gen = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=gen).to(device=device,
                                                dtype=cfg.dtype)


def batch_fn(lm: MarkovLM, args, device, cfg=None):
    """make_batch(step): the MarkovLM batch of that step on ``device``
    (a pure function of the step: a resumed run sees the same data);
    for a vlm ``cfg`` also ``prefix_embeds`` (batch, P, d_model), for an
    encdec one ``frames`` (batch, seq, d_model), in ``cfg.dtype``,
    standard normal from :func:`prefix_seed` / :func:`frames_seed`."""
    family = None if cfg is None else cfg.family

    def make_batch(step):
        b = lm.batch(args.data_seed, step, args.batch, args.seq)
        out = {k: torch.from_numpy(v).to(device) for k, v in b.items()}
        if family == "vlm":
            out["prefix_embeds"] = _normal(
                prefix_seed(args.data_seed, step),
                (args.batch, cfg.n_prefix_tokens, cfg.d_model), cfg, device)
        if family == "encdec":
            out["frames"] = _normal(frames_seed(args.data_seed, step),
                                    (args.batch, args.seq, cfg.d_model),
                                    cfg, device)
        return out
    return make_batch


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=list_archs())
    ap.add_argument("--reduced", action="store_true",
                    help="CPU-scale reduced config (same structure)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--vocab", type=int, default=256,
                    help="vocabulary of the model and the data; 0 keeps "
                         "the config's")
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--warmup", type=int, default=10)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--quant-policy", default=None,
                    help="mixed-precision policy: preset name "
                         "(paper_default | serving_aggressive | mixed_paper), "
                         "'uniform:<bits>[:<constraint>]', inline JSON, or "
                         "@policy.json; supersedes --quant-bits")
    ap.add_argument("--quant-bits", type=int, default=4,
                    help="legacy uniform knob (ignored when --quant-policy "
                         "is given)")
    ap.add_argument("--quant-constraint", default="pow2",
                    choices=["none", "pow2", "binary", "ternary"])
    ap.add_argument("--quant-min-size", type=int, default=4096)
    ap.add_argument("--act-bits", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--data-seed", type=int, default=0)
    ap.add_argument("--mesh", default=None, metavar="DxM",
                    help="not ported yet (ROADMAP queue 1, multi-GPU): "
                    "raises")
    ap.add_argument("--grad-compress", default=None, choices=("ef", "ring"),
                    help="not ported yet (ROADMAP queue 1, multi-GPU): "
                    "raises")
    ap.add_argument("--autotune", default="off",
                    choices=("off", "cache", "search"),
                    help="only 'off' is ported (ROADMAP queue 1, tuning "
                    "and benches)")
    ap.add_argument("--tuning-cache", default=None, metavar="PATH")
    ap.add_argument("--autotune-batch", type=int, default=8)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where to train; cuda raises when no card is found")
    return ap


def main(argv=None):
    args = parser().parse_args(argv)
    args.device = resolve_device(args.device)
    cfg, state, step_fn = build(args)
    lm = MarkovLM(cfg.vocab, seed=args.data_seed)
    loop = TrainLoop(step_fn, batch_fn(lm, args, args.device, cfg),
                     ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                     log_every=10, quant_policy=api.resolved_policy(cfg))
    state, step = loop.run(state, args.steps)
    losses = [h["loss"] for h in loop.history]
    if losses:
        print(f"[train] {args.arch}: loss {losses[0]:.4f} -> {losses[-1]:.4f} "
              f"(floor ~{lm.entropy_floor():.3f}) in {step} steps")
    print(f"[train] kmeans_stats launches {kmeans_stats.COUNTS['launches']}, "
          f"plain {kmeans_stats.COUNTS['plain']} | device {args.device}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
