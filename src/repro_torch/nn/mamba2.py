"""Mamba2 (SSD) block: chunked scan, LUT-Q aware projections.

Counterpart of ``repro.nn.mamba2``. State-space recurrence a head
(scalar decay, Mamba2):

    h_t = a_t * h_{t-1} + dt_t * B_t x_t^T        h in R^{N x P}
    y_t = C_t h_t + D * x_t
with a_t = exp(-dt_t * exp(A_log)).

A prefill runs the chunked SSD algorithm: inside a chunk the quadratic
"attention-like" form through a segment-sum decay matrix, across chunks
a Python loop carries the f32 state, one chunk's (B, H, L, L) decay at
a time, as the reference's ``lax.scan`` does; under autograd each
chunk is recomputed in the backward, as the reference's checkpointed
chunk body is. A decode step is one
recurrence step that writes the new SSM state and conv window into the
cache's tensors in place (the reference returns new arrays), so that a
captured CUDA graph of the step replays on the same addresses and each
replay advances the state.

``in_proj`` and ``out_proj`` are products (``linear_apply`` ->
``kernels.ops.lutq_dot``: kernels 1, 2 and 4); the depthwise conv's
``conv_w`` is a LUT-Q leaf too, decoded by ``nn/linear.materialize``
(int8, packed or pow2-encoded; through the STE on a train-form leaf,
so the gradient reaches its master) and applied as four elementwise
multiplies. The scan is plain torch, as the reference's is plain
``jnp``. The dtypes follow JAX's promotion: at a bf16 working dtype the
conv's f32 bias lifts the conv output, and with it x, B, C and the
whole scan, to f32; ``y`` returns to the working dtype after the gate.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.nn.linear import (Linear, linear_apply, linear_init,
                                   materialize, silu)
from repro_torch.nn.tree import leaf

CONV_K = 4


class Mamba2(nn.Module):
    """State-dict keys as the reference's dict: ``in_proj.kernel``,
    ``out_proj.kernel``, ``conv_w`` (CONV_K, conv_dim), ``conv_b``,
    ``A_log``, ``D``, ``dt_bias`` (H,)."""

    def __init__(self, in_proj: Linear, out_proj: Linear, conv_w, conv_b,
                 A_log, D, dt_bias):
        super().__init__()
        self.in_proj, self.out_proj = in_proj, out_proj
        for name, t in (("conv_w", conv_w), ("conv_b", conv_b),
                        ("A_log", A_log), ("D", D), ("dt_bias", dt_bias)):
            setattr(self, name, nn.Parameter(t))


def mamba2_init(gen, d_model: int, *, d_inner: int, n_state: int = 64,
                head_dim: int = 64, device=None) -> Mamba2:
    """Random fp32 parameters: the projections from ``gen``, the conv
    weight normal x 0.2, A_log = log(linspace(1, 16, H)), D = 1 and
    dt_bias the softplus inverse of 0.01, as the reference's init."""
    n_heads = d_inner // head_dim
    conv_dim = d_inner + 2 * n_state
    in_proj = linear_init(gen, d_model, 2 * d_inner + 2 * n_state + n_heads,
                          device=device)
    out_proj = linear_init(gen, d_inner, d_model, device=device)
    conv_w = torch.randn((CONV_K, conv_dim), generator=gen,
                         device=device) * 0.2
    f32 = dict(dtype=torch.float32, device=device)
    return Mamba2(
        in_proj, out_proj, conv_w, torch.zeros((conv_dim,), **f32),
        torch.log(torch.linspace(1.0, 16.0, n_heads, **f32)),
        torch.ones((n_heads,), **f32),
        torch.log(torch.expm1(torch.full((n_heads,), 0.01, **f32))))


def _einsum(eq: str, *ops: torch.Tensor) -> torch.Tensor:
    """``jnp.einsum``: the operands promoted to their common dtype first
    (``torch.einsum`` refuses mixed dtypes)."""
    dt = ops[0].dtype
    for t in ops[1:]:
        dt = torch.promote_types(dt, t.dtype)
    return torch.einsum(eq, *(t.to(dt) for t in ops))


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``, i.e. ``logaddexp(x, 0)``: max(x, 0) +
    log1p(exp(-|x|)), NaN kept (``F.softplus`` switches to x above a
    threshold instead)."""
    out = torch.clamp(x, min=0) + torch.log1p(torch.exp(-x.abs()))
    return torch.where(torch.isnan(x), x, out)


def _causal_conv(x: torch.Tensor, w, b: torch.Tensor,
                 state: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv over the sequence. x: (B, S, C); w: (K, C)
    (a tensor or a LutqState, decoded to x's dtype); ``state``: the last
    K - 1 inputs (B, K - 1, C), zeros if None. Returns (silu(conv + b),
    the new window). The K products sum in x's dtype, in the
    reference's order; the bias add promotes."""
    w = materialize(w, x.dtype)
    B, S, C = x.shape
    if state is None:
        state = torch.zeros((B, CONV_K - 1, C), dtype=x.dtype,
                            device=x.device)
    xp = torch.cat([state.to(x.dtype), x], dim=1)  # (B, S + K - 1, C)
    y = xp[:, 0:S] * w[0]
    for i in range(1, CONV_K):
        y = y + xp[:, i:i + S] * w[i]
    return silu(y + b), xp[:, -(CONV_K - 1):]


def _segsum(logd: torch.Tensor) -> torch.Tensor:
    """Lower-triangular pairwise decay exponents: out[t, s] =
    sum_{s < i <= t} logd_i. logd: (..., L); out (..., L, L), -inf above
    the diagonal."""
    L = logd.shape[-1]
    cs = torch.cumsum(logd, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((L, L), dtype=torch.bool,
                                 device=logd.device))
    return torch.where(mask, diff, torch.full_like(diff, float("-inf")))


def _ssd_chunk(h, xk, dtk, Bk, Ck, A):
    """One chunk of the SSD scan: the state h (B, H, N, P) f32 in, its
    successor and the chunk's y (B, L, H, P) out."""
    logd = (-dtk * A[None, None, :]).to(torch.float32)       # (B, L, H)
    # intra-chunk: y[t] = sum_{s<=t} C_t.B_s exp(seg) dt_s x_s
    decay = torch.exp(_segsum(logd.transpose(1, 2)))         # (B, H, L, L)
    cb = _einsum("bln,bsn->bls", Ck, Bk)                     # (B, L, L)
    scores = cb[:, None] * decay * dtk.transpose(1, 2)[:, :, None, :]
    y = _einsum("bhls,bshp->blhp", scores, xk)
    # inter-chunk: y[t] += C_t exp(cum_t) h_in
    cum = torch.cumsum(logd, dim=1)                          # (B, L, H)
    y = y + _einsum("bln,blh,bhnp->blhp", Ck, torch.exp(cum), h)
    # h' = (chunk decay) h + sum_s exp(cum_L - cum_s) dt_s B_s x_s^T
    decay_to_end = torch.exp(cum[:, -1:, :] - cum)
    state = _einsum("blh,blh,bln,blhp->bhnp", decay_to_end, dtk, Bk, xk)
    return h * torch.exp(cum[:, -1, :])[..., None, None] + state, y


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                Bm: torch.Tensor, Cm: torch.Tensor, *, chunk: int = 128,
                h0: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD. x (B, S, H, P), dt (B, S, H) after softplus, A (H,)
    positive decay rates, Bm / Cm (B, S, N). Returns (y (B, S, H, P) in
    x's dtype, h_final (B, H, N, P) f32). S pads to a chunk multiple
    with identity steps (dt = 0: decay 1, no input). Under autograd each
    chunk's body is recomputed in the backward
    (``torch.utils.checkpoint``), as the reference's ``@jax.checkpoint
    chunk_body``: only the chunk-boundary states are kept, and one
    chunk's (B, H, L, L) decay and scores live at a time in the backward
    too."""
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    chunk = min(chunk, S)
    S0, pad = S, (-S) % chunk
    if pad:
        def rpad(t):
            return torch.nn.functional.pad(
                t, (0, 0) * (t.ndim - 2) + (0, pad))
        x, dt, Bm, Cm = rpad(x), rpad(dt), rpad(Bm), rpad(Cm)
        S += pad
    h = (torch.zeros((B, H, N, P), dtype=torch.float32, device=x.device)
         if h0 is None else h0)
    remat = torch.is_grad_enabled()
    ys = []
    for j in range(0, S, chunk):
        part = (h, x[:, j:j + chunk], dt[:, j:j + chunk],
                Bm[:, j:j + chunk], Cm[:, j:j + chunk], A)
        if remat:
            h, y = checkpoint(_ssd_chunk, *part, use_reentrant=False)
        else:
            h, y = _ssd_chunk(*part)
        ys.append(y)
    y = torch.cat(ys, dim=1)[:, :S0]
    return y.to(x.dtype), h


def _split_in(p: Mamba2, u, d_inner: int, n_state: int, backend: str,
              act_bits: int):
    """in_proj of u, split into (z, xbc, dt)."""
    zxbcdt = linear_apply(p.in_proj, u, backend=backend, act_bits=act_bits)
    return torch.split(zxbcdt, [d_inner, d_inner + 2 * n_state,
                                zxbcdt.shape[-1] - 2 * d_inner
                                - 2 * n_state], dim=-1)


def mamba2_forward(p: Mamba2, u: torch.Tensor, *, d_inner: int,
                   n_state: int = 64, head_dim: int = 64, chunk: int = 128,
                   backend: str = "auto", act_bits: int = 32
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """u (B, S, D) -> (out (B, S, D), {"ssm": (B, H, N, P) f32, "conv":
    (B, K - 1, conv_dim)}): the state after the last of the S
    positions (a prefill runs each prompt at its exact length)."""
    B, S, _ = u.shape
    H = d_inner // head_dim
    z, xbc, dt = _split_in(p, u, d_inner, n_state, backend, act_bits)
    xbc, conv_state = _causal_conv(xbc, leaf(p, "conv_w"), p.conv_b)
    x, Bm, Cm = torch.split(xbc, [d_inner, n_state, n_state], dim=-1)
    dt = softplus(dt.to(torch.float32) + p.dt_bias)
    xh = x.reshape(B, S, H, head_dim)
    y, hT = ssd_chunked(xh, dt, torch.exp(p.A_log), Bm, Cm, chunk=chunk)
    y = y + xh * p.D[None, None, :, None]
    y = (y.reshape(B, S, d_inner) * silu(z)).to(u.dtype)
    out = linear_apply(p.out_proj, y, backend=backend, act_bits=act_bits)
    return out, {"ssm": hT, "conv": conv_state}


def mamba2_decode(p: Mamba2, u: torch.Tensor, state: Dict[str, torch.Tensor],
                  *, d_inner: int, n_state: int = 64, head_dim: int = 64,
                  backend: str = "auto", act_bits: int = 32) -> torch.Tensor:
    """One token a row, u (B, 1, D) -> out (B, 1, D). Reads
    ``state["ssm"]`` (B, H, N, P) f32 and ``state["conv"]`` (B, K - 1,
    conv_dim) and writes their successors into them in place."""
    B = u.shape[0]
    H = d_inner // head_dim
    z, xbc, dt = _split_in(p, u, d_inner, n_state, backend, act_bits)
    xbc, conv_state = _causal_conv(xbc, leaf(p, "conv_w"), p.conv_b,
                                   state["conv"])
    x, Bm, Cm = torch.split(xbc, [d_inner, n_state, n_state], dim=-1)
    dt = softplus(dt.to(torch.float32) + p.dt_bias)[:, 0]   # (B, H)
    a = torch.exp(-dt * torch.exp(p.A_log)[None, :])
    xh = x.reshape(B, H, head_dim)
    h = state["ssm"] * a[..., None, None] + _einsum(
        "bh,bn,bhp->bhnp", dt, Bm[:, 0], xh)
    y = _einsum("bn,bhnp->bhp", Cm[:, 0], h) + xh * p.D[None, :, None]
    y = (y.reshape(B, 1, d_inner) * silu(z)).to(u.dtype)
    state["ssm"].copy_(h)
    state["conv"].copy_(conv_state)
    return linear_apply(p.out_proj, y, backend=backend, act_bits=act_bits)
