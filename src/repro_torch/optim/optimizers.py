"""Functional optimizers over named tensors (counterpart of
``repro.optim.optimizers``).

The paper's Table 1 uses SGD for step 3; AdamW serves the larger
models. An optimizer works on the *trainable* view of a model
(``repro_torch.core.policy.split_trainable``: the LUT-Q masters and the
float leaves), as ``{name: tensor}`` dicts of parameters, gradients and
moments. The arithmetic follows the reference op by op in float32
(``(m / c1) / (sqrt(v / c2) + eps) + wd * p``, then ``p - lr * upd``),
through ``torch._foreach_*`` ops, and not ``torch.optim``, whose rounding
differs. Parameters and moments are updated in place: the port keeps
one copy of each, where the reference returns new trees. Schedules and
the bias corrections are float32 scalars computed on the host, so a
step needs no device synchronisation. Square roots are taken in float64
and rounded once to float32 (:func:`sqrt_rn_`): correctly rounded, as
the reference's ``jnp.sqrt`` is on the CPU, where the card's float32
root is not.
"""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Union

import numpy as np
import torch

from repro_torch.device import scalar_like

Schedule = Union[float, Callable[[int], float]]
Named = Dict[str, torch.Tensor]


def _f32(x) -> float:
    """x rounded to float32, as a Python float (exact in f32 ops)."""
    return float(np.float32(x))


def _lr_at(lr: Schedule, step: int) -> float:
    return _f32(lr(step) if callable(lr) else lr)


class Optimizer(NamedTuple):
    init: Callable    # (params) -> opt_state
    update: Callable  # (grads, opt_state, params, step) -> None, in place


def _lists(names, *dicts):
    return [[d[n] for n in names] for d in dicts]


#: elements of one float64 chunk in :func:`sqrt_rn_` (32 MiB)
SQRT_CHUNK = 1 << 22


@torch.no_grad()
def sqrt_rn_(tensors) -> None:
    """Replace each float32 tensor by its correctly rounded square root,
    in place: the root of the float64 copy (exact to 53 bits) rounded
    once to float32, which is correctly rounded since 53 >= 2 * 24 + 2.
    Taken in chunks of :data:`SQRT_CHUNK` elements, so no float64 copy
    of a whole leaf is made."""
    for t in tensors:
        for part in t.view(-1).split(SQRT_CHUNK):
            part.copy_(part.double().sqrt_())


def sgd(lr: Schedule, momentum: float = 0.9, weight_decay: float = 0.0,
        nesterov: bool = False) -> Optimizer:
    def init(params: Named):
        if momentum == 0.0:
            return {}
        return {"m": {n: torch.zeros_like(p) for n, p in params.items()}}

    @torch.no_grad()
    def update(grads: Named, state, params: Named, step: int) -> None:
        lr_t = _lr_at(lr, step)
        names = list(params)
        p, g = _lists(names, params, grads)
        if weight_decay:  # eff = g + wd * p
            g = torch._foreach_add(g, torch._foreach_mul(p, weight_decay))
        if momentum == 0.0:
            torch._foreach_sub_(p, torch._foreach_mul(g, lr_t))
            return
        (m,) = _lists(names, state["m"])
        torch._foreach_mul_(m, momentum)  # m = momentum * m + eff
        torch._foreach_add_(m, g)
        # d = eff + momentum * m (nesterov) or m; p = p - lr * d
        upd = (torch._foreach_add(g, torch._foreach_mul(m, momentum))
               if nesterov else m)
        torch._foreach_sub_(p, torch._foreach_mul(upd, lr_t))

    return Optimizer(init, update)


def adamw(lr: Schedule, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.0) -> Optimizer:
    def init(params: Named):
        return {"m": {n: torch.zeros_like(p) for n, p in params.items()},
                "v": {n: torch.zeros_like(p) for n, p in params.items()}}

    @torch.no_grad()
    def update(grads: Named, state, params: Named, step: int) -> None:
        lr_t = _lr_at(lr, step)
        t = np.float32(step) + np.float32(1.0)
        c1 = _f32(np.float32(1.0) - np.float32(b1) ** t)
        c2 = _f32(np.float32(1.0) - np.float32(b2) ** t)
        names = list(params)
        p, g, m, v = _lists(names, params, grads, state["m"], state["v"])
        # m = b1 * m + (1 - b1) * g
        torch._foreach_mul_(m, b1)
        torch._foreach_add_(m, torch._foreach_mul(g, 1 - b1))
        # v = b2 * v + (1 - b2) * g * g
        torch._foreach_mul_(v, b2)
        gg = torch._foreach_mul(g, 1 - b2)
        torch._foreach_mul_(gg, g)
        torch._foreach_add_(v, gg)
        del gg
        # upd = (m / c1) / (sqrt(v / c2) + eps) + wd * p
        den = torch._foreach_div(v, scalar_like(c2, v[0]))
        sqrt_rn_(den)
        torch._foreach_add_(den, eps)
        upd = torch._foreach_div(m, scalar_like(c1, m[0]))
        torch._foreach_div_(upd, den)
        del den
        if weight_decay:
            torch._foreach_add_(upd, torch._foreach_mul(p, weight_decay))
        # p = p - lr * upd
        torch._foreach_mul_(upd, lr_t)
        torch._foreach_sub_(p, upd)

    return Optimizer(init, update)


@torch.no_grad()
def clip_by_global_norm(grads: Named, max_norm: float):
    """Scale every gradient in place by min(1, max_norm / ||g||); returns
    (grads, ||g||) with the norm taken before clipping, as a float32
    0-dim tensor on the gradients' device."""
    gs = list(grads.values())
    norms = torch._foreach_norm([g.float() for g in gs])
    gn = torch.stack(norms).square().sum()
    sqrt_rn_([gn])
    scale = torch.clamp(scalar_like(max_norm, gn) / torch.clamp(gn, min=1e-12),
                        max=1.0)
    torch._foreach_mul_(gs, scale)
    return grads, gn


def cosine_schedule(peak: float, warmup: int, total: int, floor: float = 0.1):
    """Linear warm-up to ``peak``, then cosine decay to ``floor * peak``
    at ``total``: a float32 function of the step, in the reference's op
    order."""
    f = np.float32
    lo = f(floor * peak)
    amp = f((1 - floor) * peak * 0.5)

    def fn(step: int) -> float:
        s = f(step)
        warm = f(peak) * s / f(max(warmup, 1))
        frac = np.clip((s - f(warmup)) / f(max(total - warmup, 1)),
                       f(0.0), f(1.0))
        cos = lo + amp * (f(1.0) + np.cos(f(np.pi) * frac))
        return float(warm if s < warmup else cos)

    return fn
