"""Uniform activation fake-quantization with a straight-through gradient.

Counterpart of ``repro.core.actquant.fake_quant`` and
``fake_quant_frozen``. Symmetric per-tensor uniform quantization in the
working dtype, in the reference's op order: amax, ``/ qmax``, round half
to even, clip. The value is ``x + (q - x).detach()``, as the reference's
``x + stop_gradient(q - x)``: it rounds exactly as the reference's does,
and its gradient to x is the identity. Calibration is not ported yet.
"""
from __future__ import annotations

import torch


def fake_quant(x: torch.Tensor, bits: int = 8) -> torch.Tensor:
    """q = clip(round(x / s), -2^{b-1}, 2^{b-1}-1) * s, s = max|x| / qmax
    (amax detached); gradient = identity."""
    if bits >= 32:
        return x
    qmax = 2.0 ** (bits - 1) - 1.0
    scale = torch.clamp(x.detach().abs().max(), min=1e-8) / qmax
    q = torch.clamp(torch.round(x / scale), -qmax - 1.0, qmax) * scale
    return x + (q - x).detach()


def fake_quant_frozen(x: torch.Tensor, act: torch.Tensor) -> torch.Tensor:
    """Fake-quant against a frozen calibration pair ``act = [scale, qmax]``;
    gradient = identity."""
    scale = act[..., 0].float()
    qmax = act[..., 1].float()
    s = torch.where(scale > 0, scale, torch.ones_like(scale))
    q = (torch.clamp(torch.round(x.float() / s), -qmax, qmax) * s).to(x.dtype)
    return x + (q - x).detach()
