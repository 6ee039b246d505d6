"""Train state + the full LUT-Q train step (paper Table 1, steps 1-4).

Counterpart of ``repro.optim.train_state``. The step composes:
  1/2. forward with tied weights Q = d[A] (STE) + backward -> dC/dQ
  3.   optimizer update of the full-precision masters W
  4.   M k-means iterations refreshing every (d, A) pair
plus microbatch gradient accumulation and global-norm clipping.

The model holds everything: its trainable parameters are the reference's
``trainable`` tree and its buffers the ``static`` one
(:func:`repro_torch.core.policy.split_trainable`). A step updates the
model and the optimizer moments in place and returns the same state.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.core.policy import kmeans_tree, split_trainable
from repro_torch.models.config import ModelConfig
from repro_torch.optim.optimizers import Optimizer, clip_by_global_norm

_MESH_TODO = ("is not ported yet: multi-GPU training, ROADMAP queue 1 "
              "item 8")


@dataclasses.dataclass
class TrainState:
    model: nn.Module        # masters + fp params (trainable), LUT-Q (d, A)
    opt_state: Any          # {"m": {name: tensor}, ...} per the optimizer
    step: int = 0


def init_train_state(model: nn.Module, optimizer: Optimizer, *,
                     grad_compress: bool = False) -> TrainState:
    if grad_compress:
        raise NotImplementedError(f"grad_compress {_MESH_TODO}")
    trainable, _ = split_trainable(model)
    return TrainState(model=model, opt_state=optimizer.init(trainable),
                      step=0)


def make_train_step(
    cfg: ModelConfig,
    loss_fn: Callable,
    optimizer: Optimizer,
    *,
    microbatches: int = 1,
    clip_norm: Optional[float] = 1.0,
    grad_transform: Optional[Callable] = None,
    shardings: Optional[Dict[str, Any]] = None,
    kmeans_impl: Optional[str] = None,
):
    """Build ``train_step(state, batch) -> (state, metrics)``.

    loss_fn(model, cfg, batch) -> (loss, metrics). ``microbatches``
    splits the batch along its first axis and sums the gradients of the
    parts before dividing by their number, as the reference's scan does.
    kmeans_impl: force the step-4 implementation per
    ``repro_torch.core.lutq.resolve_kmeans_impl`` (None = structural).
    Metrics are 0-dim tensors on the model's device (no synchronisation).
    """
    if grad_transform is not None:
        raise NotImplementedError(f"grad_transform {_MESH_TODO}")
    if shardings is not None:
        raise NotImplementedError(f"shardings {_MESH_TODO}")

    def split_micro(batch):
        def r(x):
            b = x.shape[0]
            if b % microbatches:
                raise ValueError(f"batch {b} does not split into "
                                 f"{microbatches} microbatches")
            return x.reshape(microbatches, b // microbatches, *x.shape[1:])
        parts = {k: r(v) for k, v in batch.items()}
        return [{k: v[i] for k, v in parts.items()}
                for i in range(microbatches)]

    def train_step(state: TrainState, batch) -> Tuple[TrainState,
                                                      Dict[str, Any]]:
        model = state.model
        trainable, _ = split_trainable(model)
        for p in trainable.values():
            p.grad = None

        if microbatches > 1:
            losses = []
            for mb in split_micro(batch):
                l, _ = loss_fn(model, cfg, mb)
                l.backward()  # accumulates into .grad: the sum of parts
                losses.append(l.detach())
            loss = sum(losses) / microbatches
            metrics = {}
        else:
            loss, metrics = loss_fn(model, cfg, batch)
            loss.backward()
            loss = loss.detach()
        grads = {n: p.grad if p.grad is not None else torch.zeros_like(p)
                 for n, p in trainable.items()}
        if microbatches > 1:
            torch._foreach_div_(list(grads.values()), float(microbatches))

        gn = torch.zeros((), dtype=torch.float32, device=loss.device)
        if clip_norm is not None:
            grads, gn = clip_by_global_norm(grads, clip_norm)

        # step 3: optimizer update of the masters
        optimizer.update(grads, state.opt_state, trainable, state.step)
        for p in trainable.values():
            p.grad = None
        del grads

        # step 4: k-means refresh of every (d, A), each leaf under its
        # rule of the config's resolved policy (rule ids line up with
        # the ones stamped at quantize time)
        if cfg.quant is not None:
            from repro_torch.models.api import resolved_policy
            kmeans_tree(model, resolved_policy(cfg), impl=kmeans_impl)

        state.step += 1
        out = {"loss": loss, "grad_norm": gn,
               **{k: v.detach() for k, v in metrics.items()}}
        return state, out

    return train_step
