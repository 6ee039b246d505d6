"""Conv2D (NHWC), LUT-Q aware, for the paper's CNN experiments.

Counterpart of ``repro.nn.conv``. Kernels stay in the reference's HWIO
layout, so a quantized kernel's assignments have the reference's shape
(``serve_view(pack4=True)`` packs them along ``cin``, axis -2) and
weights cross :mod:`repro_torch.interop` without a transpose; the
layouts are permuted at the call. The convolution itself is PyTorch's
(the reference's is a plain ``lax`` op on the decoded weights).

Two things differ from ``F.conv2d``'s defaults:

- ``"SAME"`` padding is XLA's: ``total = max((ceil(n/s) - 1)*s + k - n,
  0)`` with ``total // 2`` before and the rest after, so a 3x3 stride-2
  conv on an even input pads 0 before and 1 after (``padding=1`` pads
  both sides and gives other values of the same shape; ``"same"``
  refuses stride 2).
- Both passes run in IEEE float32: cuDNN runs a float32 convolution in
  TF32 while ``torch.backends.cudnn.allow_tf32`` is True, its default,
  so the forward and the backward convolutions are made with TF32 off
  (:func:`_ieee_f32`, a local switch; cuDNN's other flags stay as the
  caller set them).
"""
from __future__ import annotations

import contextlib
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.nn.linear import _quant_act, materialize
from repro_torch.nn.tree import leaf


class Conv(nn.Module):
    def __init__(self, kernel: torch.Tensor):
        super().__init__()
        self.kernel = nn.Parameter(kernel)


def normal(generator: Optional[torch.Generator], shape, device
           ) -> torch.Tensor:
    """Standard normal draws of ``shape`` from a CPU generator, moved to
    ``device`` (the same values on every device); on the meta device an
    unfilled skeleton."""
    if torch.device(device or "cpu").type == "meta":
        return torch.empty(shape, device="meta")
    return torch.randn(shape, generator=generator).to(device)


def conv_init(generator: Optional[torch.Generator], kh: int, kw: int,
              cin: int, cout: int, *, dtype=torch.float32, device=None
              ) -> Conv:
    """He-normal HWIO kernel (std sqrt(2 / fan_in))."""
    fan_in = kh * kw * cin
    w = normal(generator, (kh, kw, cin, cout), device) * (2.0 / fan_in) ** 0.5
    return Conv(w.to(dtype))


def same_pads(n: int, k: int, stride: int) -> Tuple[int, int]:
    """(before, after) of XLA's ``"SAME"`` padding of one spatial axis."""
    out = -(-n // stride)
    total = max((out - 1) * stride + k - n, 0)
    return total // 2, total - total // 2


@contextlib.contextmanager
def _ieee_f32():
    """cuDNN with TF32 off; its other flags as they are."""
    c = torch.backends.cudnn
    with c.flags(enabled=c.enabled, benchmark=c.benchmark,
                 deterministic=c.deterministic, allow_tf32=False):
        yield


class _Conv2d(torch.autograd.Function):
    """``F.conv2d`` (NCHW, OIHW, no dilation or groups) whose forward and
    backward convolutions both run under :func:`_ieee_f32`."""

    @staticmethod
    def forward(ctx, x, w, stride: int, padding: Tuple[int, int]):
        ctx.save_for_backward(x, w)
        ctx.conf = (stride, padding)
        with _ieee_f32():
            return F.conv2d(x, w, stride=stride, padding=padding)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        stride, padding = ctx.conf
        with _ieee_f32():
            gx, gw, _ = torch.ops.aten.convolution_backward(
                g, x, w, None, [stride, stride], list(padding), [1, 1],
                False, [0, 0], 1,
                [ctx.needs_input_grad[0], ctx.needs_input_grad[1], False])
        return gx, gw, None, None


def conv_apply(p: Conv, x: torch.Tensor, *, stride: int = 1,
               padding: str = "SAME", act_bits: int = 32) -> torch.Tensor:
    """NHWC conv with the activation-quant regime at the kernel boundary
    (``act_bits=32`` keeps the input untouched; callers that
    pre-quantize, as the ResNet's unsigned post-ReLU activations, pass
    the default). ``padding``: ``"SAME"`` (XLA's) or ``"VALID"``."""
    kernel = leaf(p, "kernel")
    x = _quant_act(x, kernel, act_bits)
    k = materialize(kernel, x.dtype)
    kh, kw = k.shape[:2]
    if padding == "SAME":
        (t, b), (l, r) = (same_pads(x.shape[1], kh, stride),
                          same_pads(x.shape[2], kw, stride))
    elif padding == "VALID":
        t = b = l = r = 0
    else:
        raise ValueError(f"padding {padding!r}: expected 'SAME' or 'VALID'")
    xn = x.permute(0, 3, 1, 2)  # NHWC -> NCHW (a channels-last view)
    if (t, l) != (b, r):
        xn, pad = F.pad(xn, (l, r, t, b)), (0, 0)
    else:
        pad = (t, l)
    y = _Conv2d.apply(xn, k.permute(3, 2, 0, 1), stride, pad)
    return y.permute(0, 2, 3, 1)
