"""The CIFAR-style quantization quality table (paper §2), counterpart of
the reference's ``benchmarks/cifar_table.py`` recipe.

    PYTHONPATH=src python -m repro_torch.launch.cifar_table
    PYTHONPATH=src python -m repro_torch.launch.cifar_table --device cpu \\
        --steps 20

Trains the same ResNet-20 on the procedural shapes task
(``data.synthetic.shapes_dataset``: 2048 training and 512 held-out
images) under the paper's configurations (:data:`CONFIGS`) and reports
the held-out error of each, which the paper orders on CIFAR-10 as

    fp32  <=  LUT-Q 4-bit (quasi)  <=  fully multiplier-less 4-bit
          <=  LUT-Q 2-bit (quasi)  <=  fully multiplier-less 2-bit

"quasi" = pow2 weights + standard BN; "fully" = pow2 weights + ML-BN +
8-bit activations. A step (:func:`train_step`) is the reference's:
loss and gradient, AdamW (cosine schedule, peak 2e-3, 20 warm-up
steps), ``kmeans_tree`` over every quantized leaf (``kmeans_iters=1``,
``min_size=256``), then the new BN running statistics merged into the
old. The defaults are the reference's CPU scale (widths 8/16/32, one
block a stage, 16x16 images, batch 64, 240 steps); ``--widths 16 32 64
--blocks 3 --res 32 --batch 128`` is ResNet-20 proper at CIFAR's
resolution.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import time
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core.mlbn import BNStats
from repro_torch.core.policy import kmeans_tree, quantize_tree, split_trainable
from repro_torch.core.spec import QuantSpec
from repro_torch.data.synthetic import class_batches, shapes_dataset
from repro_torch.device import resolve_device
from repro_torch.models.resnet import (classify_loss, init_resnet20,
                                       resnet20_apply)
from repro_torch.nn.tree import module_device
from repro_torch.optim.optimizers import Optimizer, adamw, cosine_schedule

WIDTHS = (8, 16, 32)
BLOCKS = 1
STEPS = 240
BATCH = 64
RES = 16
N_TRAIN, N_TEST = 2048, 512

#: (label, spec, multiplier_less, act_bits), the reference's seven rows
CONFIGS = [
    ("fp32 baseline", None, False, 32),
    ("LUT-Q 4-bit pow2 (quasi ML)", QuantSpec(bits=4, constraint="pow2"),
     False, 32),
    ("LUT-Q 4-bit pow2 (fully ML)", QuantSpec(bits=4, constraint="pow2"),
     True, 8),
    ("LUT-Q 2-bit pow2 (quasi ML)", QuantSpec(bits=2, constraint="pow2"),
     False, 32),
    ("LUT-Q 2-bit pow2 (fully ML)", QuantSpec(bits=2, constraint="pow2"),
     True, 8),
    # the paper's special cases: constrained dictionaries reproduce TWN
    # and BinaryConnect inside the same training loop
    ("ternary a*{-1,0,1} (TWN case)",
     QuantSpec(bits=2, constraint="ternary", fixed_scale=True), False, 32),
    ("binary {-1,1} (BinaryConnect)", QuantSpec(bits=1, constraint="binary"),
     False, 32),
]


def config(label: str):
    """The :data:`CONFIGS` row named ``label``."""
    for row in CONFIGS:
        if row[0] == label:
            return row
    raise KeyError(f"no configuration {label!r}; expected one of "
                   f"{[r[0] for r in CONFIGS]}")


def table_spec(spec: QuantSpec, prune: float = 0.0) -> QuantSpec:
    """A row's spec as the recipe trains it."""
    return dataclasses.replace(spec, prune_frac=prune, kmeans_iters=1,
                               min_size=256)


def train_step(model, stats: Dict[str, BNStats], opt: Optimizer, opt_state,
               n: int, batch, *, spec: Optional[QuantSpec] = None, **kw):
    """One step of the recipe on ``model``, in place: loss and gradient
    of :func:`repro_torch.models.resnet.classify_loss` (``kw``: widths,
    blocks, multiplier_less, act_bits), ``opt`` on the trainable leaves
    at step ``n``, ``kmeans_tree`` under ``spec`` (None: no LUT-Q), and
    the new running statistics merged into ``stats``. Returns (stats,
    loss, accuracy), the last two 0-dim tensors (no synchronisation)."""
    trainable, _ = split_trainable(model)
    for p in trainable.values():
        p.grad = None
    loss, (new_stats, acc) = classify_loss(model, stats, batch, **kw)
    loss.backward()
    grads = {k: p.grad if p.grad is not None else torch.zeros_like(p)
             for k, p in trainable.items()}
    opt.update(grads, opt_state, trainable, n)
    for p in trainable.values():
        p.grad = None
    if spec is not None:
        kmeans_tree(model, spec)
    stats = {**stats, **{k: BNStats(v.mean.detach(), v.var.detach())
                         for k, v in new_stats.items()}}
    return stats, loss.detach(), acc.detach()


class Trained(NamedTuple):
    model: torch.nn.Module
    stats: Dict[str, BNStats]
    losses: List[float]       # every step's loss
    seconds: float            # training wall, first step included


def to_device(b, dev) -> Dict[str, torch.Tensor]:
    return {"x": torch.from_numpy(b["x"]).to(dev),
            "y": torch.from_numpy(b["y"]).to(dev)}


def train(spec: Optional[QuantSpec], *, multiplier_less: bool = False,
          act_bits: int = 32, seed: int = 0, steps: int = STEPS,
          prune: float = 0.0, widths=WIDTHS, blocks: int = BLOCKS,
          res: int = RES, batch: int = BATCH, device="cuda") -> Trained:
    """Train one row's network on ``shapes_dataset(2048, seed=1)``."""
    dev = resolve_device(device)
    xs, ys = shapes_dataset(N_TRAIN, seed=1, res=res)
    model, stats = init_resnet20(torch.Generator().manual_seed(seed),
                                 widths=widths, blocks=blocks, device=dev)
    if spec is not None:
        spec = table_spec(spec, prune)
        quantize_tree(model, spec)
    opt = adamw(cosine_schedule(2e-3, 20, steps))
    opt_state = opt.init(split_trainable(model)[0])
    kw = dict(widths=widths, blocks=blocks, multiplier_less=multiplier_less,
              act_bits=act_bits)
    it = class_batches(xs, ys, batch, seed=3)
    losses = []
    t0 = time.perf_counter()
    for n in range(steps):
        stats, loss, _ = train_step(model, stats, opt, opt_state, n,
                                    to_device(next(it), dev), spec=spec,
                                    **kw)
        losses.append(loss)
    losses = torch.stack(losses).tolist() if losses else []
    return Trained(model, stats, losses, time.perf_counter() - t0)


@torch.no_grad()
def error_rate(model, stats, xt: np.ndarray, yt: np.ndarray, *,
               widths=WIDTHS, blocks: int = BLOCKS,
               multiplier_less: bool = False, act_bits: int = 32,
               eval_batch: int = 128) -> float:
    """Held-out error in percent: the mean of per-batch accuracies of an
    inference forward (``training=False``), as the reference averages."""
    dev = module_device(model)
    accs = []
    for s in range(0, len(xt), eval_batch):
        x = torch.from_numpy(xt[s:s + eval_batch]).to(dev)
        y = torch.from_numpy(yt[s:s + eval_batch]).to(dev)
        logits, _ = resnet20_apply(model, stats, x, widths=widths,
                                   blocks=blocks, training=False,
                                   multiplier_less=multiplier_less,
                                   act_bits=act_bits)
        accs.append((logits.argmax(-1) == y).float().mean())
    return 100.0 * (1.0 - float(torch.stack(accs).mean()))


def train_one(spec: Optional[QuantSpec], *, multiplier_less: bool = False,
              act_bits: int = 32, seed: int = 0, steps: int = STEPS,
              prune: float = 0.0, widths=WIDTHS, blocks: int = BLOCKS,
              res: int = RES, batch: int = BATCH, device="cuda") -> float:
    """Train one row and return its error (%) on ``shapes_dataset(512,
    seed=2)``."""
    t = train(spec, multiplier_less=multiplier_less, act_bits=act_bits,
              seed=seed, steps=steps, prune=prune, widths=widths,
              blocks=blocks, res=res, batch=batch, device=device)
    xt, yt = shapes_dataset(N_TEST, seed=2, res=res)
    return error_rate(t.model, t.stats, xt, yt, widths=widths,
                      blocks=blocks, multiplier_less=multiplier_less,
                      act_bits=act_bits)


def run(emit=print, steps: int = STEPS, **kw):
    """Every row of :data:`CONFIGS`; ``kw`` as :func:`train_one`'s.
    Returns [(label, error %)]."""
    rows = []
    for label, spec, ml, act in CONFIGS:
        t0 = time.perf_counter()
        err = train_one(spec, multiplier_less=ml, act_bits=act, steps=steps,
                        **kw)
        emit(f"  {label:32s} err {err:5.1f}%  "
             f"({time.perf_counter() - t0:.0f}s)")
        rows.append((label, err))
    emit(f"  ordering check: fp32 {rows[0][1]:.1f}% <= 4-bit quasi "
         f"{rows[1][1]:.1f}% (paper: 7.4 -> 7.6)")
    return rows


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=STEPS)
    ap.add_argument("--widths", type=int, nargs=3, default=list(WIDTHS))
    ap.add_argument("--blocks", type=int, default=BLOCKS)
    ap.add_argument("--res", type=int, default=RES)
    ap.add_argument("--batch", type=int, default=BATCH)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where to train; cuda raises when no card is found")
    return ap


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    run(steps=args.steps, widths=tuple(args.widths), blocks=args.blocks,
        res=args.res, batch=args.batch, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
