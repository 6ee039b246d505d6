"""Uniform activation fake-quantization with a straight-through gradient,
and calibration of frozen activation scales.

Counterpart of ``repro.core.actquant``. Symmetric per-tensor uniform
quantization in the working dtype, in the reference's op order: amax,
``/ qmax``, round half to even, clip. The value is
``x + (q - x).detach()``, as the reference's ``x + stop_gradient(q -
x)``: it rounds exactly as the reference's does, and its gradient to x
is the identity. :func:`relu_fake_quant` (unsigned, post-ReLU) and
:func:`learned_clip_fake_quant` (a trained clip) divide the same way.

Calibration: inside :func:`capture_act_scales` (model), the matmul
boundary (``nn.linear.dot_kernel``) folds max|x| of every call into one
running maximum per logical (stacked) path of the model's quantized
leaves (:func:`record_amax`), so the layers of one logical leaf share one
maximum, as the slices of the reference's stacked leaf do;
:func:`apply_act_scales` freezes the maxima into ``[scale, qmax]``
pairs.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Optional, Tuple

import torch

from repro_torch.core.lutq import LutqState
from repro_torch.device import scalar_like


def fake_quant(x: torch.Tensor, bits: int = 8) -> torch.Tensor:
    """q = clip(round(x / s), -2^{b-1}, 2^{b-1}-1) * s, s = max|x| / qmax
    (amax detached); gradient = identity."""
    if bits >= 32:
        return x
    qmax = 2.0 ** (bits - 1) - 1.0
    # the quotient in float32, rounded once to x's dtype, as on the CPU
    amax = torch.clamp(x.detach().abs().max(), min=1e-8)
    scale = (amax / scalar_like(qmax, x)).to(x.dtype)
    q = torch.clamp(torch.round(x / scale), -qmax - 1.0, qmax) * scale
    return x + (q - x).detach()


def relu_fake_quant(x: torch.Tensor, bits: int = 8) -> torch.Tensor:
    """Unsigned variant for post-ReLU activations: relu, then q = clip(
    round(x / s), 0, 2^b - 1) * s with s = max|x| / (2^b - 1) (amax
    detached); gradient = relu's."""
    x = torch.relu(x)
    if bits >= 32:
        return x
    qmax = 2.0 ** bits - 1.0
    amax = torch.clamp(x.detach().abs().max(), min=1e-8)
    scale = (amax / scalar_like(qmax, x)).to(x.dtype)
    q = torch.clamp(torch.round(x / scale), 0.0, qmax) * scale
    return x + (q - x).detach()


def learned_clip_fake_quant(x: torch.Tensor, alpha: torch.Tensor,
                            bits: int = 8) -> torch.Tensor:
    """PACT-style fake-quant with a learned clip: a = |alpha| + 1e-6,
    xc = clip(x, -a, a), q = round(xc / s) * s with s = a / qmax.

    The value is q; the gradient is the identity inside the range and
    reaches ``alpha`` through the clip boundary. The clip is
    ``minimum(maximum(x, -a), a)``, as ``jnp.clip`` is, so a value on the
    boundary splits its gradient between x and alpha as the
    reference's does.
    """
    if bits >= 32:
        return x
    qmax = 2.0 ** (bits - 1) - 1.0
    a = torch.as_tensor(alpha, device=x.device).abs() + 1e-6
    xc = torch.minimum(torch.maximum(x, -a), a)
    scale = a / scalar_like(qmax, a)
    q = torch.round(xc / scale) * scale
    return xc + (q - xc).detach()


def fake_quant_frozen(x: torch.Tensor, act: torch.Tensor) -> torch.Tensor:
    """Fake-quant against a frozen calibration pair ``act = [scale, qmax]``;
    gradient = identity."""
    scale = act[..., 0].float()
    qmax = act[..., 1].float()
    s = torch.where(scale > 0, scale, torch.ones_like(scale))
    q = (torch.clamp(torch.round(x.float() / s), -qmax, qmax) * s).to(x.dtype)
    return x + (q - x).detach()


# ---------------------------------------------------------------------------
# calibration: capture per-leaf activation maxima, freeze [scale, qmax]
# ---------------------------------------------------------------------------

# Active capture: ({id(d): logical path of the leaf}, {path: running
# max |x|}). None == not capturing.
_CAPTURE: Optional[Tuple[Dict[int, str], Dict[str, torch.Tensor]]] = None


@contextlib.contextmanager
def capture_act_scales(model: torch.nn.Module):
    """Context manager yielding the ``{logical path: amax}`` record dict.

    Run calibration forwards of ``model`` inside the block; a quantized
    leaf is known by its dictionary tensor ``d``. While the block runs
    the maxima are 0-dim device tensors (no host sync per call); on
    leaving it they are read in one transfer and the dict holds Python
    floats.
    """
    from repro_torch.nn.tree import QuantKernel, logical_path

    global _CAPTURE
    paths = {id(mod.d): "/".join(logical_path(tuple(name.split(".")))[0])
             for name, mod in model.named_modules()
             if isinstance(mod, QuantKernel)}
    prev, _CAPTURE = _CAPTURE, (paths, {})
    rec = _CAPTURE[1]
    try:
        yield rec
    finally:
        _CAPTURE = prev
        if rec:
            vals = torch.stack([v.float() for v in rec.values()]).tolist()
            rec.update(zip(list(rec), vals))


def capturing() -> bool:
    """A :func:`capture_act_scales` block is active: forwards must run
    eagerly, since a replayed CUDA graph would record nothing."""
    return _CAPTURE is not None


def record_amax(kernel: LutqState, x: torch.Tensor) -> None:
    """Fold max|x| into the active capture record under ``kernel``'s
    logical path (no-op when inactive or for a leaf of another model).

    Every call of one logical leaf, from any layer, folds into one
    maximum: calibration is per logical leaf, not per layer.
    """
    if _CAPTURE is None:
        return
    paths, rec = _CAPTURE
    path = paths.get(id(kernel.d))
    if path is None:
        return
    amax = x.detach().abs().amax().float()
    prev = rec.get(path)
    rec[path] = amax if prev is None else torch.maximum(prev, amax)


def apply_act_scales(model: torch.nn.Module, record: Dict[str, float],
                     quant=None) -> torch.nn.Module:
    """Freeze captured maxima into each quantized leaf's ``act`` pair, in
    place; returns ``model``.

    Only leaves whose governing rule (under ``quant``, a QuantPolicy /
    QuantSpec / None) has ``act_frozen=True`` and ``act_bits < 32`` are
    filled: ``act = [amax / qmax, qmax]`` with ``qmax = 2^(act_bits-1)
    - 1`` (clamped to the int8 range by the pow2 consumers), the same
    pair on every layer of a logical leaf, broadcast over an expert
    stack (act (E, 2), the reference's shape). Others keep theirs.
    """
    from repro_torch.core.rules import as_policy
    from repro_torch.nn.tree import QuantKernel, logical_path

    pol = as_policy(quant)
    if pol is None:
        return model
    for name, mod in model.named_modules():
        if not isinstance(mod, QuantKernel):
            continue
        lpath = logical_path(tuple(name.split(".")))[0]
        i = pol.match(lpath)
        spec = pol.rules[i].spec if i is not None else None
        if spec is None or spec.act_bits >= 32 or not spec.act_frozen:
            continue
        amax = record.get("/".join(lpath))
        if amax is None or amax <= 0.0:
            continue
        qmax = float(2.0 ** (spec.act_bits - 1) - 1.0)
        pair = torch.tensor([amax / qmax, qmax], dtype=torch.float32,
                            device=mod.d.device)
        mod.act = pair.expand(tuple(mod.d.shape[:-1]) + (2,)).clone()
    return model
