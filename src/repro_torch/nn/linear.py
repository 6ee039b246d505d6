"""Quantization-aware dense / embedding layers.

Counterpart of ``repro.nn.linear``. A layer's ``kernel`` (or ``table``)
is either a plain parameter or a :class:`QuantKernel` holding a
:class:`LutqState`. A train-form leaf (master ``w`` present) decodes
through the STE (:func:`repro_torch.core.lutq.quantize_ste_any`), so
the forward sees exactly ``d[A]`` and the gradient reaches ``w``;
matmuls with a serve-form leaf go through
:func:`repro_torch.kernels.ops.lutq_dot`, so they run the fused CUDA
kernels and the decoded weight is never materialized.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch.core.actquant import (fake_quant, fake_quant_frozen,
                                       record_amax)
from repro_torch.core.lutq import (LutqState, decode_any, index_of,
                                   quantize_ste_any)
from repro_torch.kernels.ops import lutq_dot
from repro_torch.kernels.ref import unpack4_kin
from repro_torch.nn.tree import leaf


class Linear(nn.Module):
    def __init__(self, kernel: torch.Tensor, bias: Optional[torch.Tensor] = None):
        super().__init__()
        self.kernel = nn.Parameter(kernel)
        if bias is not None:
            self.bias = nn.Parameter(bias)


class Embedding(nn.Module):
    def __init__(self, table: torch.Tensor):
        super().__init__()
        self.table = nn.Parameter(table)


def materialize(kernel, dtype=None) -> torch.Tensor:
    """Decoded (quantized, STE on a train-form leaf) or raw kernel, cast
    for compute."""
    if isinstance(kernel, LutqState):
        a = kernel.a
        if a.dtype == torch.uint8:  # packed 4-bit pairs (serve_view pack4)
            a = unpack4_kin(a)
        if kernel.w is None:
            k = decode_any(kernel.d, a)
        else:
            k = quantize_ste_any(kernel.w, kernel.d, a)
    else:
        k = kernel
    return k.to(dtype) if dtype is not None and k.dtype != dtype else k


def _quant_act(x: torch.Tensor, kernel, act_bits: int) -> torch.Tensor:
    """Activation quantization at the matmul boundary (the regime)."""
    if isinstance(kernel, LutqState):
        if kernel.d.dtype == torch.int8:
            return x  # pow2 planes quantize inside their backend
        if kernel.act is not None:
            return fake_quant_frozen(x, kernel.act)
    if act_bits < 32:
        return fake_quant(x, act_bits)
    return x


def dot_kernel(x: torch.Tensor, kernel, *, dtype=None, backend: str = "auto",
               transpose_rhs: bool = False, act_bits: int = 32) -> torch.Tensor:
    """``x @ kernel`` (or ``x @ kernel.T``) with LUT-Q-aware dispatch.

    Under :func:`repro_torch.core.actquant.capture_act_scales` the
    activation's max|x| is recorded for the leaf first, before it is
    quantized (as in the reference).
    """
    if isinstance(kernel, LutqState):
        record_amax(kernel, x)
    x = _quant_act(x, kernel, act_bits)
    if isinstance(kernel, LutqState):
        return lutq_dot(x, kernel, backend=backend,
                        transpose_rhs=transpose_rhs,
                        out_dtype=dtype or x.dtype)
    k = materialize(kernel, dtype or x.dtype)
    return torch.matmul(x, k.transpose(-1, -2) if transpose_rhs else k)


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.sigmoid``: 1 / (1 + exp(-x)), each step rounded to the
    working dtype. ``torch.sigmoid`` rounds once, which moves bf16
    outputs by an ulp."""
    return 1.0 / (1.0 + torch.exp(-x))


def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu``: x * sigmoid(x), each step rounded to the working
    dtype. ``torch.nn.functional.silu`` rounds once, which moves a third
    of bf16 outputs by an ulp."""
    return x * sigmoid(x)


def linear_init(generator: Optional[torch.Generator], in_dim: int,
                out_dim: int, *, bias: bool = False,
                dtype=torch.float32, device=None,
                scale: Optional[float] = None) -> Linear:
    if scale is None:
        scale = in_dim ** -0.5
    kernel = (torch.randn((in_dim, out_dim), generator=generator,
                          device=device) * scale).to(dtype)
    b = torch.zeros((out_dim,), dtype=dtype, device=device) if bias else None
    return Linear(kernel, b)


def linear_apply(p: Linear, x: torch.Tensor, *, dtype=None,
                 backend: str = "auto", act_bits: int = 32) -> torch.Tensor:
    y = dot_kernel(x, leaf(p, "kernel"), dtype=dtype, backend=backend,
                   act_bits=act_bits)
    if hasattr(p, "bias"):
        y = y + p.bias.to(y.dtype)
    return y


def embedding_init(generator: Optional[torch.Generator], vocab: int,
                   dim: int, *, dtype=torch.float32, device=None) -> Embedding:
    table = (torch.randn((vocab, dim), generator=generator, device=device)
             * 0.02).to(dtype)
    return Embedding(table)


def embedding_apply(p: Embedding, ids: torch.Tensor, *, dtype=None
                    ) -> torch.Tensor:
    """Rows ``ids`` of the (decoded) table.

    A train-form table decodes through the STE and then gathers, as the
    reference does, so the gradient reaches the master. A serve-form
    table gathers the assignment rows first and decodes only those
    (``d[a[ids]] == d[a][ids]``); a packed table takes row r's nibble
    from packed row ``r // 2``: there the full table is never decoded.
    """
    t = leaf(p, "table")
    ids = ids.long()
    if not isinstance(t, LutqState) or t.w is not None:
        return materialize(t, dtype)[ids]
    if t.d.ndim != 1:
        raise ValueError("embedding_apply: one dictionary per table expected")
    if t.a.dtype == torch.uint8:
        byte = t.a[ids // 2]                               # (..., D)
        shift = ((ids % 2) * 4).to(torch.uint8)[..., None]
        idx = ((byte >> shift) & 0xF).long()
    else:
        idx = index_of(t.a[ids])
    rows = t.d[idx]
    return rows.to(dtype) if dtype is not None else rows


def embedding_logits(p: Embedding, x: torch.Tensor, *, backend: str = "auto",
                     act_bits: int = 32) -> torch.Tensor:
    """Tied-softmax readout: x @ table.T."""
    return dot_kernel(x, leaf(p, "table"), backend=backend,
                      transpose_rhs=True, act_bits=act_bits)
