"""Multiplier-less batch normalization (paper Appendix A).

Counterpart of ``repro.core.mlbn``. At inference BN collapses to
``y = a*x + b`` with ``a = gamma / sqrt(VAR + eps)``. ML-BN requires
``a`` to be a power of two, so inference needs only shifts and adds.
During training the forward pass uses the pow2-rounded scale while the
backward pass updates the full-precision gamma through the STE.

Written by hand rather than with ``F.batch_norm``: the reference
normalizes by the population variance and keeps running statistics as
``momentum * old + (1 - momentum) * batch`` (momentum 0.9), where torch's
batch norm keeps the unbiased variance and weighs the other way.

The scale's ``1 / sqrt(var + eps)`` is taken in float64 and rounded once
to float32 (:func:`_rsqrt`), so the card's scale has the CPU's bits:
the card's float32 ``rsqrt`` is not correctly rounded, and an ulp there
can move ``pow2_round(a)`` across a rounding boundary. The reference's
XLA ``rsqrt`` is not correctly rounded either, so against it the scale
agrees to about an ulp.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
from torch import nn

from repro_torch.core.lutq import exact_exp2, pow2_round

#: frexp mantissas above this round |a| up to the next power of two (as
#: a float32 it lies just below sqrt(1/2), so ``>`` is exact there)
_SQRT_HALF = 0.5 ** 0.5


class BNParams(NamedTuple):
    gamma: torch.Tensor  # full-precision, trained
    beta: torch.Tensor


class BNStats(NamedTuple):
    mean: torch.Tensor  # running mean of inputs
    var: torch.Tensor   # running (population) variance of inputs


class BNAffine(nn.Module):
    """The trained ``gamma`` and ``beta`` of one BN as parameters (the
    reference's ``BNParams`` leaf: paths ``....p.gamma`` / ``....p.beta``)."""

    def __init__(self, params: BNParams):
        super().__init__()
        self.gamma = nn.Parameter(params.gamma)
        self.beta = nn.Parameter(params.beta)

    @property
    def params(self) -> BNParams:
        return BNParams(self.gamma, self.beta)


def init_bn(num_features: int, dtype=torch.float32, device=None
            ) -> Tuple[BNParams, BNStats]:
    def full(v):
        return torch.full((num_features,), v, dtype=dtype, device=device)
    return BNParams(full(1.0), full(0.0)), BNStats(full(0.0), full(1.0))


def _rsqrt(v: torch.Tensor) -> torch.Tensor:
    """``1 / sqrt(v)`` from float64 ops (correctly rounded on every
    device), rounded once to v's dtype; differentiable."""
    return torch.sqrt(v.double()).reciprocal().to(v.dtype)


def _ml_scale(gamma: torch.Tensor, var: torch.Tensor, eps: float
              ) -> torch.Tensor:
    """Effective scale a = gamma / sqrt(var + eps), pow2-rounded with STE."""
    a = gamma * _rsqrt(var + eps)
    return a + (pow2_round(a) - a).detach()


def _feature_shape(x: torch.Tensor, axis: int):
    shape = [1] * x.ndim
    shape[axis % x.ndim] = x.shape[axis % x.ndim]
    return shape


def batch_norm(x: torch.Tensor, params: BNParams, stats: BNStats, *,
               training: bool, multiplier_less: bool = False,
               eps: float = 1e-5, momentum: float = 0.9, axis: int = -1
               ) -> Tuple[torch.Tensor, BNStats]:
    """BN over all axes except ``axis`` (the feature axis).

    Returns (y, new_stats). With ``multiplier_less=True`` the effective
    scale is pow2-rounded (STE on gamma), so the inference form
    ``y = pow2(a)*x + b`` is multiplier-less.
    """
    ax = axis % x.ndim
    dims = tuple(i for i in range(x.ndim) if i != ax)
    if training:
        mean = x.mean(dim=dims)
        centered = x - mean.reshape(_feature_shape(x, ax))
        var = (centered * centered).mean(dim=dims)
        new_stats = BNStats(
            momentum * stats.mean + (1 - momentum) * mean.detach(),
            momentum * stats.var + (1 - momentum) * var.detach())
    else:
        mean, var = stats.mean, stats.var
        new_stats = stats

    if multiplier_less:
        a = _ml_scale(params.gamma, var, eps)
    else:
        a = params.gamma * _rsqrt(var + eps)
    b = params.beta - a * mean
    shape = _feature_shape(x, ax)
    return a.reshape(shape) * x + b.reshape(shape), new_stats


def apply_scale_offset_shift(x: torch.Tensor, a: torch.Tensor,
                             b: torch.Tensor, *, axis: int = -1
                             ) -> torch.Tensor:
    """``y = a*x + b`` for exact-pow2 ``a``, as a sign flip, an exponent
    shift and an add (the ML-BN inference claim made literal).

    ``e`` is the exponent of the power of two nearest |a|, read exactly
    from ``torch.frexp`` (the reference's ``round(log2|a|)``); the shift
    is ``x * 2^e`` with ``2^e`` built from its bits
    (:func:`repro_torch.core.lutq.exact_exp2`), which is exact, as
    ``ldexp`` is (``torch.ldexp`` forms ``2**e`` with a float ``pow``).
    Bit-identical to ``a*x + b`` for ``a = ±2^k`` in the normal float
    range, ``a = 0`` included.
    """
    shape = _feature_shape(x, axis)
    a = a.reshape(shape)
    b = b.reshape(shape)
    nz = a != 0
    m, ex = torch.frexp(torch.where(nz, a.abs(), torch.ones_like(a)))
    e = ex - 1 + (m > _SQRT_HALF).to(ex.dtype)
    y = torch.where(a < 0, -x, x) * exact_exp2(torch.clamp(e, -126, 127)
                                               ).to(x.dtype)
    return torch.where(nz, y, torch.zeros((), dtype=x.dtype,
                                          device=x.device)) + b


def inference_scale_offset(params: BNParams, stats: BNStats, *,
                           multiplier_less: bool = False, eps: float = 1e-5
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The folded (a, b) used at inference; a is exact pow2 under ML-BN."""
    a = params.gamma * _rsqrt(stats.var + eps)
    if multiplier_less:
        a = pow2_round(a)
    b = params.beta - a * stats.mean
    return a, b
