"""RWKV6 (Finch): attention-free time-mix with a data-dependent decay.

Counterpart of ``repro.nn.rwkv6``. Per head, with state S in R^{dk x dv}:

    y_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)
    S_t = diag(w_t) S_{t-1} + k_t v_t^T

where the decay w_t = exp(-exp(w0 + tanh(x_t w1) w2)) is data-dependent.
Token-shift mixing uses static learned lerp coefficients (``mix_*``), the
reference's simplification of the paper's data-dependent mix LoRA; the
data-dependent decay is kept.

The scan is the exact recurrence, one step a token in f32 (plain torch,
as the reference's ``lax.scan`` is plain ``jnp``). The reference runs it
in chunks only to choose what its backward pass rematerializes; its
padding steps (w = 1, k = v = r = 0) leave the state bit for bit as it
was, so serving runs one loop over the tokens here, and under autograd
the loop runs in chunks of ``chunk`` tokens (the config's
``ssm_chunk``), each recomputed in the backward. No exp-ratio "chunked
parallel" form (which is not exact for every decay) replaces it.

``r``, ``k``, ``v``, ``g``, ``o`` and the channel-mix's ``cm_k``,
``cm_v``, ``cm_r`` are products (``linear_apply`` ->
``kernels.ops.lutq_dot``: kernels 1, 2 and 4), and so are the decay
LoRA's bare leaves ``w1`` (d_model -> 64) and ``w2`` (64 -> d_model),
through ``dot_kernel``. The model keeps its residual stream in f32, so
every product here takes f32 activations. A decode step writes the new
WKV state and both token-shift rows into the cache's tensors in place
(the reference returns new arrays), so that a captured CUDA graph of the
step replays on the same addresses and each replay advances the state.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.nn.linear import (Linear, dot_kernel, linear_apply,
                                   linear_init, sigmoid, silu)
from repro_torch.nn.norms import RMSNorm, rmsnorm_apply
from repro_torch.nn.tree import leaf

#: the time-mix's token-shift lerps, then the channel-mix's
TIME_MIXES = ("mix_r", "mix_k", "mix_v", "mix_g", "mix_w")
CHANNEL_MIXES = ("mix_ck", "mix_cr")


class RWKV6(nn.Module):
    """State-dict keys as the reference's dict: ``r.kernel`` ...
    ``o.kernel``, ``cm_k.kernel``, ``cm_v.kernel``, ``cm_r.kernel``; the
    bare decay-LoRA leaves ``w1`` (D, lora) and ``w2`` (lora, D); and
    f32 ``w0``, ``u``, ``ln_x``, ``mix_*`` (D,)."""

    def __init__(self, linears: Dict[str, Linear], w1, w2, w0, u, ln_x,
                 mixes: Dict[str, torch.Tensor]):
        super().__init__()
        for name, lin in linears.items():
            setattr(self, name, lin)
        for name, t in (("w0", w0), ("w1", w1), ("w2", w2), ("u", u),
                        ("ln_x", ln_x), *mixes.items()):
            setattr(self, name, nn.Parameter(t))


def rwkv6_init(gen, d_model: int, *, decay_lora: int = 64,
               d_ff: Optional[int] = None, device=None) -> RWKV6:
    """Random fp32 parameters, the reference's: the products from
    ``gen``, w0 = -0.6, w1 and w2 normal x 0.02, u normal x 0.1, the
    lerps 0.5 and ln_x 1 (the heads are set at apply time)."""
    dff = d_ff or 4 * d_model
    lin = {name: linear_init(gen, d_model, d_model, device=device)
           for name in ("r", "k", "v", "g", "o")}
    f32 = dict(dtype=torch.float32, device=device)
    w0 = torch.full((d_model,), -0.6, **f32)
    w1 = torch.randn((d_model, decay_lora), generator=gen, **f32) * 0.02
    w2 = torch.randn((decay_lora, d_model), generator=gen, **f32) * 0.02
    u = torch.randn((d_model,), generator=gen, **f32) * 0.1
    lin["cm_k"] = linear_init(gen, d_model, dff, device=device)
    lin["cm_v"] = linear_init(gen, dff, d_model, device=device)
    lin["cm_r"] = linear_init(gen, d_model, d_model, device=device)
    mixes = {m: torch.full((d_model,), 0.5, **f32)
             for m in TIME_MIXES + CHANNEL_MIXES}
    return RWKV6(lin, w1, w2, w0, u, torch.ones((d_model,), **f32), mixes)


def _shift(x: torch.Tensor, prev: Optional[torch.Tensor]
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Token shift: x_{t-1} at each position; ``prev`` (B, 1, D) is the
    previous segment's last token (zeros if None). Returns (shifted, the
    new last token)."""
    B, S, D = x.shape
    if prev is None:
        prev = torch.zeros((B, 1, D), dtype=x.dtype, device=x.device)
    return torch.cat([prev, x[:, :-1]], dim=1), x[:, -1:].contiguous()


def _mix(x: torch.Tensor, xs: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    return x + (xs - x) * m[None, None, :].to(x.dtype)


def _wkv_steps(r, k, v, w, u, s):
    """The recurrence over the L steps of r, k, w (B, L, H, dk) and v
    (B, L, H, dv) from the state s: (y (B, L, H, dv), the state after
    the last step)."""
    ys = []
    bonus = u[None, :, :, None]
    for t in range(r.shape[1]):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]      # (B, H, dk, dv)
        ys.append(torch.einsum("bhk,bhkv->bhv", r[:, t], s + bonus * kv))
        s = w[:, t, :, :, None] * s + kv
    return torch.stack(ys, dim=1), s


def wkv_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             w: torch.Tensor, u: torch.Tensor, s0: torch.Tensor, *,
             chunk: Optional[int] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The exact WKV recurrence, a step a token. r, k, w (B, S, H, dk);
    v (B, S, H, dv); u (H, dk); s0 (B, H, dk, dv). Returns (y (B, S, H,
    dv), the state after the last step).

    Under autograd, with ``chunk``, the steps run in chunks of ``chunk``
    tokens, each recomputed in the backward (``torch.utils.checkpoint``),
    as the reference's ``@jax.checkpoint chunk_fn``: only the
    chunk-boundary states are kept, not every token's (B, H, dk, dv)
    state. The chunks change no bit of the forward; without autograd
    (serving) one loop runs over all S steps."""
    if chunk is None or not torch.is_grad_enabled():
        return _wkv_steps(r, k, v, w, u, s0)
    s, ys = s0, []
    for j in range(0, r.shape[1], chunk):
        y, s = checkpoint(_wkv_steps, r[:, j:j + chunk], k[:, j:j + chunk],
                          v[:, j:j + chunk], w[:, j:j + chunk], u, s,
                          use_reentrant=False)
        ys.append(y)
    return torch.cat(ys, dim=1), s


def _head_norm(y: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6
               ) -> torch.Tensor:
    """``rmsnorm_apply`` over each head's last axis, with a (H, dh) gain
    in place of a module's (D,) scale."""
    dt = y.dtype
    y32 = y.float()
    var = torch.mean(y32 * y32, dim=-1, keepdim=True)
    return (y32 * torch.rsqrt(var + eps) * scale.float()).to(dt)


def rwkv6_time_mix(p: RWKV6, x: torch.Tensor,
                   state: Optional[Dict[str, torch.Tensor]], *,
                   head_dim: int = 64, chunk: Optional[int] = None,
                   backend: str = "auto", act_bits: int = 32
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x (B, S, D) -> (out (B, S, D), {"shift_t": (B, 1, D), "wkv": (B,
    H, dk, dv) f32}). ``state`` holds the previous ``shift_t`` and
    ``wkv`` (zeros if None); ``chunk``: :func:`wkv_scan`'s backward
    chunk."""
    B, S, D = x.shape
    H = D // head_dim
    xs, new_prev = _shift(x, None if state is None else state["shift_t"])
    xr, xk, xv, xg, xw = (_mix(x, xs, getattr(p, m)) for m in TIME_MIXES)
    kw = dict(backend=backend, act_bits=act_bits)
    r = linear_apply(p.r, xr, **kw).reshape(B, S, H, head_dim)
    k = linear_apply(p.k, xk, **kw).reshape(B, S, H, head_dim)
    v = linear_apply(p.v, xv, **kw).reshape(B, S, H, head_dim)
    g = linear_apply(p.g, xg, **kw)
    lora = dot_kernel(torch.tanh(dot_kernel(xw.float(), leaf(p, "w1"),
                                            **kw)), leaf(p, "w2"), **kw)
    logw = -torch.exp(torch.clamp(p.w0[None, None, :] + lora, -8.0, 4.0))
    w = torch.exp(logw).reshape(B, S, H, head_dim)       # decay in (0, 1)
    s0 = (torch.zeros((B, H, head_dim, head_dim), dtype=torch.float32,
                      device=x.device) if state is None else state["wkv"])
    y, sT = wkv_scan(r.float(), k.float(), v.float(), w.float(),
                     p.u.reshape(H, head_dim), s0, chunk=chunk)
    # per-head normalization, then the gate
    y = _head_norm(y, p.ln_x.reshape(H, head_dim)).reshape(B, S, D)
    y = y.to(x.dtype)
    out = linear_apply(p.o, y * silu(g), **kw)
    return out, {"shift_t": new_prev, "wkv": sT}


def rwkv6_channel_mix(p: RWKV6, x: torch.Tensor,
                      state: Optional[Dict[str, torch.Tensor]], *,
                      backend: str = "auto", act_bits: int = 32
                      ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x (B, S, D) -> (sigmoid(cm_r x_r) * cm_v relu(cm_k x_k)^2,
    {"shift_c": (B, 1, D)})."""
    xs, new_prev = _shift(x, None if state is None else state["shift_c"])
    xk, xr = (_mix(x, xs, getattr(p, m)) for m in CHANNEL_MIXES)
    kw = dict(backend=backend, act_bits=act_bits)
    k = torch.square(torch.relu(linear_apply(p.cm_k, xk, **kw)))
    out = (sigmoid(linear_apply(p.cm_r, xr, **kw))
           * linear_apply(p.cm_v, k, **kw))
    return out, {"shift_c": new_prev}


def rwkv6_layer(p: RWKV6, x: torch.Tensor,
                state: Optional[Dict[str, torch.Tensor]] = None, *,
                head_dim: int = 64, backend: str = "auto",
                act_bits: int = 32
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The reference's ``rwkv6_layer``: the time-mix alone (the model
    assembles ln -> time-mix -> ln -> channel-mix, ``rwkv6_block``)."""
    return rwkv6_time_mix(p, x, state, head_dim=head_dim, backend=backend,
                          act_bits=act_bits)


def rwkv6_block(p: RWKV6, ln1: RMSNorm, ln2: RMSNorm, h: torch.Tensor,
                state: Optional[Dict[str, torch.Tensor]], *,
                head_dim: int = 64, chunk: Optional[int] = None,
                backend: str = "auto", act_bits: int = 32
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One pre-norm layer over the residual stream h (B, S, D): h +
    time_mix(ln1 h), then + channel_mix(ln2 h). Returns (h, {"shift_t",
    "wkv", "shift_c"}): the state after the last position. ``chunk``:
    :func:`wkv_scan`'s backward chunk."""
    kw = dict(backend=backend, act_bits=act_bits)
    t_out, t_state = rwkv6_time_mix(p, rmsnorm_apply(ln1, h), state,
                                    head_dim=head_dim, chunk=chunk, **kw)
    h = h + t_out
    c_out, c_state = rwkv6_channel_mix(p, rmsnorm_apply(ln2, h), state, **kw)
    return h + c_out, {**t_state, **c_state}


def rwkv6_decode(p: RWKV6, ln1: RMSNorm, ln2: RMSNorm, h: torch.Tensor,
                 state: Dict[str, torch.Tensor], *, head_dim: int = 64,
                 backend: str = "auto", act_bits: int = 32) -> torch.Tensor:
    """One token a row through ``rwkv6_block``, h (B, 1, D) -> h. Reads
    ``state["shift_t"]``, ``state["shift_c"]`` (B, 1, D) f32 and
    ``state["wkv"]`` (B, H, dk, dv) f32 and writes their successors into
    them in place."""
    h, new = rwkv6_block(p, ln1, ln2, h, state, head_dim=head_dim,
                         backend=backend, act_bits=act_bits)
    for key, t in new.items():
        state[key].copy_(t)
    return h
