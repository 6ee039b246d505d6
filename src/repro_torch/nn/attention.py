"""Attention: blocked online-softmax prefill and one-token decode.

Counterpart of ``repro.nn.attention.flash_attention`` (the causal path
with an optional sliding window) and ``decode_attention``, as plain
torch ops: the prefill walks (q-block, kv-block) pairs with an online
softmax, and under a window each q-block reads a fixed-width KV slab,
as the reference does. GQA folds query heads into (kv_head, group) so
no KV head is replicated. The hand-written attention kernels come in
later slices.
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def _f32_einsum(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """einsum with jnp's type promotion (mixed operands meet in the wider
    type), cast to float32."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return torch.einsum(eq, a.to(dt), b.to(dt)).float()


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    window: Optional[int] = None, q_block: int = 512,
                    kv_block: int = 512) -> torch.Tensor:
    """Causal attention. q: (B,S,H,Dh); k,v: (B,Skv,Hkv,Dh[v]) ->
    (B,S,H,Dv)."""
    B, S, H, Dh = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    Dv = v.shape[-1]
    G = H // Hkv
    scale = Dh ** -0.5
    q_block = min(q_block, S)
    kv_block = min(kv_block, Skv)
    S0, Skv0 = S, Skv
    pad_q = (-S) % q_block
    pad_kv = (-Skv) % kv_block
    if pad_q:
        q = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, pad_q))
        S += pad_q
    if pad_kv:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad_kv))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad_kv))
        Skv += pad_kv
    nq = S // q_block
    qr = q.reshape(B, nq, q_block, Hkv, G, Dh) * scale

    if window is not None:
        # static KV slab wide enough to cover [q_end - window, q_end)
        slab = ((window + kv_block - 1) // kv_block + 1) * kv_block
        slab = min(slab + (q_block // kv_block) * kv_block, Skv)
        slab = max(slab, kv_block)
        slab = (slab // kv_block) * kv_block
    else:
        slab = Skv
    nkv = slab // kv_block
    dev = q.device

    outs = []
    for qi in range(nq):
        qblk = qr[:, qi]  # (B, bq, Hkv, G, Dh)
        q_start = qi * q_block
        start = (min(max(q_start + q_block - slab, 0), Skv - slab)
                 if slab < Skv else 0)
        q_pos = q_start + torch.arange(q_block, device=dev)
        m = torch.full((B, Hkv, G, q_block, 1), NEG_INF, device=dev)
        l = torch.zeros((B, Hkv, G, q_block, 1), device=dev)
        acc = torch.zeros((B, Hkv, G, q_block, Dv), device=dev)
        for j in range(nkv):
            lo = start + j * kv_block
            kj = k[:, lo:lo + kv_block]
            vj = v[:, lo:lo + kv_block]
            k_pos = lo + torch.arange(kv_block, device=dev)
            s = _f32_einsum("bqhgd,bkhd->bhgqk", qblk, kj)
            mask = q_pos[:, None] >= k_pos[None, :]
            if window is not None:
                mask &= q_pos[:, None] - k_pos[None, :] < window
            if pad_kv:
                mask &= k_pos[None, :] < Skv0
            s = torch.where(mask, s, torch.full_like(s, NEG_INF))
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            p = torch.exp(s - m_new)
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(dim=-1, keepdim=True)
            vj_t = vj.transpose(1, 2).float()  # (B, Hkv, bk, Dv)
            acc = acc * alpha + torch.einsum("bhgqk,bhkd->bhgqd", p, vj_t)
            m = m_new
        out = acc / torch.clamp(l, min=1e-30)
        # (B, Hkv, G, bq, Dv) -> (B, bq, H, Dv)
        outs.append(out.permute(0, 3, 1, 2, 4).reshape(B, q_block, H, Dv))
    out = torch.cat(outs, dim=1)
    if pad_q:
        out = out[:, :S0]
    return out.to(q.dtype)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cache_len: torch.Tensor, *,
                     window: Optional[int] = None) -> torch.Tensor:
    """One-token decode. q: (B,1,H,Dh); caches: (B,Skv,Hkv,Dh[v]).

    cache_len: (B,) or scalar, the number of valid cache positions.
    """
    B, _, H, Dh = q.shape
    Skv, Hkv = k_cache.shape[1], k_cache.shape[2]
    G = H // Hkv
    qr = q.reshape(B, Hkv, G, Dh) * Dh ** -0.5
    s = _f32_einsum("bhgd,bkhd->bhgk", qr, k_cache)
    pos = torch.arange(Skv, device=q.device)[None, :]
    cl = torch.as_tensor(cache_len, device=q.device).reshape(-1)
    cl = cl.expand(B).reshape(B, 1)
    valid = pos < cl
    if window is not None:
        valid &= pos >= cl - window
    s = torch.where(valid[:, None, None, :], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgk,bkhd->bhgd", p.float(), v_cache.float())
    return o.reshape(B, 1, H, -1).to(q.dtype)
