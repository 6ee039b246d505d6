"""Top-k Mixture-of-Experts with capacity-based dispatch (GShard-style).

Counterpart of ``repro.nn.moe``. Dispatch is sort-free: slot positions
come from a token-major cumulative sum over the (slots, experts)
one-hot, tokens are copied into a per-expert capacity-padded buffer
(E, C, D), the expert FFNs run as expert-stacked products, and outputs
are combined with the gate weights. Overflowing tokens are dropped to a
dump row that is sliced away; underflow is zero padding.

Expert weights carry *per-expert dictionaries* (d (E, K), a (E, Din,
Dout)): serve-form experts go through ``kernels/ops.lutq_dot_experts``,
ONE launch of an expert-stacked kernel a product (the reference vmaps
its Pallas kernels over the expert axis, one ``pallas_call`` with a
batch grid dimension). Train-form and float experts keep the dense
einsum.

Every shape is static and nothing is read on the host, so a MoE decode
step captures and replays as a CUDA graph: capacity comes from the
token count alone, kept slots are unique (a copy, not an atomic add),
and dropped slots all land on the dump row.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from repro_torch.core.actquant import fake_quant_frozen, record_amax
from repro_torch.core.lutq import LutqState
from repro_torch.device import scalar_like
from repro_torch.kernels import ops
from repro_torch.nn.linear import _quant_act, dot_kernel, materialize, silu
from repro_torch.nn.tree import leaf


class MoE(nn.Module):
    """``router`` (D, E) float32, ``wi``/``wg`` (E, D, F), ``wo`` (E, F,
    D), and with shared experts ``shared_wi``/``shared_wg`` (D, Fs),
    ``shared_wo`` (Fs, D): the reference's parameter names, as plain
    tensors (no ``kernel`` level)."""

    def __init__(self, **params: torch.Tensor):
        super().__init__()
        for name, t in params.items():
            setattr(self, name, nn.Parameter(t))


def moe_init(gen: Optional[torch.Generator], d_model: int, d_ff: int,
             n_experts: int, *, n_shared: int = 0,
             d_ff_shared: Optional[int] = None, dtype=torch.float32,
             device=None) -> MoE:
    def randn(*shape, scale):
        return (torch.randn(shape, generator=gen, device=device)
                * scale).to(dtype)

    s = d_model ** -0.5
    params = {
        "router": randn(d_model, n_experts, scale=s).float(),
        "wi": randn(n_experts, d_model, d_ff, scale=s),
        "wg": randn(n_experts, d_model, d_ff, scale=s),
        "wo": randn(n_experts, d_ff, d_model, scale=d_ff ** -0.5),
    }
    if n_shared > 0:
        dsh = d_ff_shared or d_ff * n_shared
        params["shared_wi"] = randn(d_model, dsh, scale=s)
        params["shared_wg"] = randn(d_model, dsh, scale=s)
        params["shared_wo"] = randn(dsh, d_model, scale=dsh ** -0.5)
    return MoE(**params)


def _expert_dot(buf: torch.Tensor, kernel, cdt, backend: str = "auto",
                act_bits: int = 32) -> torch.Tensor:
    """Expert-stacked product (E, C, Din) @ kernel (E, Din, Dout).

    Under calibration the whole buffer's max|x| is recorded for the leaf
    (one amax, zero padding rows included), then the buffer is
    fake-quantized as one tensor, as the reference's ``_quant_act`` does
    before its vmap (a frozen pair per expert, all equal, scales each
    expert's slab). Serve-form LUT-Q experts run
    :func:`repro_torch.kernels.ops.lutq_dot_experts`; train form and
    plain tensors the dense einsum.
    """
    if isinstance(kernel, LutqState):
        record_amax(kernel, buf)
        if (kernel.d.dtype != torch.int8 and kernel.act is not None
                and kernel.act.ndim == 2):
            buf = fake_quant_frozen(buf, kernel.act[:, None, None, :])
        else:
            buf = _quant_act(buf, kernel, act_bits)
        if kernel.w is None and kernel.d.ndim == 2 and kernel.a.ndim == 3:
            return ops.lutq_dot_experts(buf, kernel, backend=backend,
                                        out_dtype=cdt)
    else:
        buf = _quant_act(buf, kernel, act_bits)
    return torch.einsum("ecd,edf->ecf", buf, materialize(kernel, cdt))


def _top_k(probs: torch.Tensor, k: int):
    """``jax.lax.top_k``: the k largest along the last axis, an equal
    value's lower index first (a stable descending sort; ``torch.topk``
    promises no order among ties)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(router: torch.Tensor, xt: torch.Tensor, top_k: int):
    """(probs (T, E), gate values (T, k) renormalized, expert ids (T,
    k)) of tokens xt (T, D): a float32 router product, float32 softmax,
    top-k."""
    logits = torch.matmul(xt.float(), router.float())
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_ids = _top_k(probs, top_k)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)
    return probs, gate_vals, expert_ids


def capacity(T: int, top_k: int, n_experts: int,
             capacity_factor: float) -> int:
    """Slots an expert: ``max(1, ceil(T * top_k / E * cf))``."""
    return max(1, int(math.ceil(T * top_k / n_experts * capacity_factor)))


def dispatch(expert_ids: torch.Tensor, gate_vals: torch.Tensor, C: int,
             E: int):
    """(slot (T k,), keep (T k,)): slot-major flattening of the routes;
    each route's position among its expert's routes in token-major
    order (a cumulative sum of the one-hot); kept where the position is
    under the capacity and the gate is positive, its slot ``e C + pos``,
    else the dump row ``E C``."""
    e_flat = expert_ids.reshape(-1)
    g_flat = gate_vals.reshape(-1)
    # a comparison, not F.one_hot, which may check its values on the host
    onehot = (e_flat[:, None] == torch.arange(E, device=e_flat.device)
              ).long()
    pos = torch.cumsum(onehot, 0) - onehot  # routes to e before me
    pos_of = torch.take_along_dim(pos, e_flat[:, None], dim=1)[:, 0]
    keep = (pos_of < C) & (g_flat > 0)
    slot = torch.where(keep, e_flat * C + pos_of,
                       torch.full_like(pos_of, E * C))
    return slot, keep, onehot


def moe_apply(p: MoE, x: torch.Tensor, *, top_k: int,
              capacity_factor: float = 1.25, dtype=None,
              backend: str = "auto", act_bits: int = 32
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (out (B, S, D), aux load-balance loss).

    Routes every token to its top-k experts, copies the kept routes into
    the (E, C, D) capacity buffer, runs the experts (``_expert_dot``)
    and combines their outputs with the gate weights in float32. The
    shared-expert projections (deepseek) go through ``dot_kernel``.
    """
    B, S, D = x.shape
    cdt = dtype or x.dtype
    T = B * S
    xt = x.reshape(T, D)
    router = leaf(p, "router")
    E = router.shape[-1]
    probs, gate_vals, expert_ids = route(router, xt, top_k)

    C = capacity(T, top_k, E, capacity_factor)
    slot, keep, onehot = dispatch(expert_ids, gate_vals, C, E)

    # load-balance auxiliary loss (Switch): E * sum_e f_e * p_e
    me = probs.mean(dim=0)
    ce = onehot.sum(0).float() / scalar_like(T * top_k, probs)
    aux = E * torch.sum(me * ce)

    # each kept route's token in its slot; dropped routes on the dump row
    x_rep = xt[:, None, :].expand(T, top_k, D).reshape(T * top_k, D)
    buf = torch.zeros((E * C + 1, D), dtype=cdt, device=x.device)
    buf.index_copy_(0, slot, x_rep.to(cdt))
    buf = buf[:E * C].reshape(E, C, D)

    h = (_expert_dot(buf, leaf(p, "wi"), cdt, backend, act_bits)
         * silu(_expert_dot(buf, leaf(p, "wg"), cdt, backend, act_bits)))
    out_buf = _expert_dot(h, leaf(p, "wo"), cdt, backend,
                          act_bits).reshape(E * C, D)

    # combine
    gathered = out_buf[torch.clamp(slot, max=E * C - 1)]
    gathered = gathered * (keep & (slot < E * C))[:, None].to(cdt)
    combined = (gathered.float() * gate_vals.reshape(-1, 1).float()
                ).reshape(T, top_k, D).sum(1)
    out = combined.reshape(B, S, D).to(x.dtype)

    if hasattr(p, "shared_wi"):
        xs = x.to(cdt)
        sh = (dot_kernel(xs, leaf(p, "shared_wi"), backend=backend,
                         act_bits=act_bits)
              * silu(dot_kernel(xs, leaf(p, "shared_wg"), backend=backend,
                                act_bits=act_bits)))
        out = out + dot_kernel(sh, leaf(p, "shared_wo"), backend=backend,
                               act_bits=act_bits).to(x.dtype)
    return out, aux


def moe_apply_dense(p: MoE, x: torch.Tensor, *, top_k: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Oracle: every expert on every token, masked combine. O(T E)
    compute; equal to :func:`moe_apply` where nothing drops."""
    B, S, D = x.shape
    xt = x.reshape(-1, D)
    probs, gv, ei = route(leaf(p, "router"), xt, top_k)
    E = probs.shape[-1]
    gates = torch.zeros_like(probs).scatter(1, ei, gv)
    wi, wg, wo = (materialize(leaf(p, k), xt.dtype)
                  for k in ("wi", "wg", "wo"))
    h = (torch.einsum("td,edf->tef", xt, wi)
         * silu(torch.einsum("td,edf->tef", xt, wg)))
    per_e = torch.einsum("tef,efd->ted", h, wo)
    out = torch.einsum("ted,te->td", per_e, gates.to(xt.dtype))
    me = probs.mean(0)
    ce = (ei.reshape(-1, 1) == torch.arange(E, device=ei.device)
          ).sum(0).float()
    ce = ce / scalar_like(ei.numel(), probs)
    if hasattr(p, "shared_wi"):
        sh = (xt @ materialize(leaf(p, "shared_wi"), xt.dtype)) * silu(
            xt @ materialize(leaf(p, "shared_wg"), xt.dtype))
        out = out + sh @ materialize(leaf(p, "shared_wo"), xt.dtype)
    return out.reshape(B, S, D), E * torch.sum(me * ce)
