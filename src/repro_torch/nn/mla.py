"""Multi-head Latent Attention (DeepSeek-V2), LUT-Q aware.

Counterpart of ``repro.nn.mla``. The KV cache stores only the compressed
latent ``c_kv`` (rank r = ``kv_lora``) plus the shared RoPE key — the MLA
memory win. Prefill and training run the *expanded* form: ``uk`` and
``uv`` expand the latents of every position into per-head keys and
values, and causal attention runs over q/k heads of ``qk_nope +
qk_rope`` (scale ``(qk_nope + qk_rope) ** -0.5``) and v heads of
``v_head``. Decode uses the *absorbed* form: q_nope is projected
through the decoded ``uk`` so scores are taken directly against the
latent, and the attention output over latents is expanded through the
decoded ``uv``, so a step costs O(H * r) a cached position instead of
re-expanding the whole cache.

The five products ``q``, ``dkv``, ``uk``, ``uv``, ``o`` go through
``linear_apply`` (``kernels/ops.lutq_dot`` on a LUT-Q leaf). The two
absorbed einsums contract per-head 3-D reshapes of the up-projections:
no (Kin, N) matmul for ``lutq_dot`` to take, so they run on the decoded
weights in the working dtype, with no activation quantization, as in the
reference (under ``serving_pow2`` they are float products). The
reference assembles the combined q/k heads through 0/1 selection
matrices for its SPMD partitioner, bitwise equal to the concatenation
used here; RoPE takes the default theta (10000), as the reference's
calls do.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.nn.attention import NEG_INF, flash_attention, scaled
from repro_torch.nn.linear import linear_apply, linear_init, materialize
from repro_torch.nn.rotary import apply_rope
from repro_torch.nn.tree import leaf


class MLA(nn.Module):
    """The five linears, named as the reference's dict keys."""

    def __init__(self, q, dkv, uk, uv, o):
        super().__init__()
        self.q, self.dkv, self.uk, self.uv, self.o = q, dkv, uk, uv, o


def mla_init(gen: Optional[torch.Generator], d_model: int, n_heads: int, *,
             kv_lora: int = 512, qk_nope: int = 128, qk_rope: int = 64,
             v_head: int = 128, device=None) -> MLA:
    return MLA(
        linear_init(gen, d_model, n_heads * (qk_nope + qk_rope),
                    device=device),
        linear_init(gen, d_model, kv_lora + qk_rope, device=device),
        linear_init(gen, kv_lora, n_heads * qk_nope, device=device),
        linear_init(gen, kv_lora, n_heads * v_head, device=device),
        linear_init(gen, n_heads * v_head, d_model, device=device))


def _split_q(p: MLA, x, n_heads, qk_nope, qk_rope, **kw):
    B, S, _ = x.shape
    q = linear_apply(p.q, x, **kw).reshape(B, S, n_heads, qk_nope + qk_rope)
    return q[..., :qk_nope], q[..., qk_nope:]


def mla_forward(p: MLA, x: torch.Tensor, positions: torch.Tensor, *,
                n_heads: int, kv_lora: int = 512, qk_nope: int = 128,
                qk_rope: int = 64, v_head: int = 128, backend: str = "auto",
                act_bits: int = 32
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Training / prefill (expanded form). x: (B, S, D). Returns (out,
    {"c_kv": (B, S, r), "k_rope": (B, S, qk_rope)})."""
    B, S, _ = x.shape
    kw = dict(backend=backend, act_bits=act_bits)
    qn, qr = _split_q(p, x, n_heads, qk_nope, qk_rope, **kw)
    qr = apply_rope(qr, positions)
    dkv = linear_apply(p.dkv, x, **kw)
    c_kv, k_rope = dkv[..., :kv_lora], dkv[..., kv_lora:]
    k_rope = apply_rope(k_rope[..., None, :], positions)  # (B, S, 1, rope)
    kn = linear_apply(p.uk, c_kv, **kw).reshape(B, S, n_heads, qk_nope)
    v = linear_apply(p.uv, c_kv, **kw).reshape(B, S, n_heads, v_head)
    # combined heads [nope ; rope], the rope key shared by every head;
    # flash_attention's Dh ** -0.5 is (qk_nope + qk_rope) ** -0.5
    k = torch.cat([kn, k_rope.expand(B, S, n_heads, qk_rope)], dim=-1)
    q = torch.cat([qn, qr], dim=-1)
    o = flash_attention(q, k, v)
    out = linear_apply(p.o, o.reshape(B, S, n_heads * v_head), **kw)
    return out, {"c_kv": c_kv, "k_rope": k_rope[..., 0, :]}


def mla_decode(p: MLA, x: torch.Tensor, cache: Dict[str, torch.Tensor],
               pos: torch.Tensor, *, n_heads: int, kv_lora: int = 512,
               qk_nope: int = 128, qk_rope: int = 64, v_head: int = 128,
               backend: str = "auto", act_bits: int = 32) -> torch.Tensor:
    """One-token decode against the latent cache (absorbed form).

    x: (B, 1, D); cache: {"c_kv": (B, Skv, r), "k_rope": (B, Skv,
    qk_rope)}; pos: (B, 1) the new token's positions (the cache's
    lengths). The new latent and rope key are written into the cache
    tensors in place (the reference returns new arrays) at ``min(pos,
    Skv - 1)``, where ``dynamic_update_slice`` clamps; nothing is read
    on the host, so a CUDA graph of the step replays at every length.
    """
    B = x.shape[0]
    c_kv, k_rope = cache["c_kv"], cache["k_rope"]
    Skv = c_kv.shape[1]
    kw = dict(backend=backend, act_bits=act_bits)
    qn, qr = _split_q(p, x, n_heads, qk_nope, qk_rope, **kw)
    qr = apply_rope(qr, pos)  # the new token at position cache_len
    dkv = linear_apply(p.dkv, x, **kw)
    c_new, kr_new = dkv[..., :kv_lora], dkv[..., kv_lora:]
    kr_new = apply_rope(kr_new[..., None, :], pos)[..., 0, :]

    idx = pos[:, 0].long()
    rows = torch.arange(B, device=x.device)
    slot = torch.clamp(idx, max=Skv - 1)
    c_kv[rows, slot] = c_new[:, 0].to(c_kv.dtype)
    k_rope[rows, slot] = kr_new[:, 0].to(k_rope.dtype)

    # absorbed scores: q_nope W_uk^T -> latent space
    wuk = materialize(leaf(p.uk, "kernel"), x.dtype).reshape(
        kv_lora, n_heads, qk_nope)
    q_lat = torch.einsum("bhd,rhd->bhr", qn[:, 0], wuk)  # (B, H, r)
    s = torch.einsum("bhr,bkr->bhk", q_lat, c_kv)
    s = s + torch.einsum("bhd,bkd->bhk", qr[:, 0], k_rope)
    s = scaled(s, (qk_nope + qk_rope) ** -0.5).float()
    valid = torch.arange(Skv, device=x.device)[None, :] <= idx[:, None]
    s = torch.where(valid[:, None, :], s, torch.full_like(s, NEG_INF))
    prob = torch.softmax(s, dim=-1)

    o_lat = torch.einsum("bhk,bkr->bhr", prob.to(x.dtype), c_kv)  # (B, H, r)
    wuv = materialize(leaf(p.uv, "kernel"), x.dtype).reshape(
        kv_lora, n_heads, v_head)
    o = torch.einsum("bhr,rhv->bhv", o_lat, wuv).reshape(
        B, 1, n_heads * v_head)
    return linear_apply(p.o, o, **kw)
