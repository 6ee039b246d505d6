"""Attention: blocked online-softmax prefill, one-token decode, pages.

Counterpart of ``repro.nn.attention``: ``flash_attention`` (causal with
an optional sliding window, a ``q_offset`` for chunked prefill
against a workspace and a bidirectional ``prefix`` for a vlm's image
tokens, or unmasked, ``causal=False``, for cross-attention),
``decode_attention``, and the block-table
helpers ``gather_pages`` / ``scatter_token_pages`` of the paged KV
cache, as plain torch ops. The prefill walks (q-block, kv-block) pairs
with an online softmax, and under a window each q-block reads a
fixed-width KV slab, as the reference does. GQA folds query heads into
(kv_head, group) so no KV head is replicated. Per-token positions and
segments (``q_positions`` / ``kv_positions`` / ``q_segments`` /
``kv_segments``) let one call attend several packed sequences, as the
paged engine's packed prefill does. The paged decode kernel is
``kernels/paged_attn.py``.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

NEG_INF = -1e30


def scaled(q: torch.Tensor, scale: float) -> torch.Tensor:
    """``q * scale`` as jnp computes it: the Python scalar takes q's
    dtype first (bf16 rounds 80**-0.5), then the product rounds once."""
    return q * torch.tensor(scale, dtype=q.dtype)


def _f32_einsum(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """einsum with jnp's type promotion (mixed operands meet in the wider
    type), cast to float32."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return torch.einsum(eq, a.to(dt), b.to(dt)).float()


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    window: Optional[int] = None,
                    prefix: Optional[int] = None, q_block: int = 512,
                    kv_block: int = 512,
                    q_offset: Union[int, torch.Tensor] = 0,
                    q_positions: Optional[torch.Tensor] = None,
                    kv_positions: Optional[torch.Tensor] = None,
                    q_segments: Optional[torch.Tensor] = None,
                    kv_segments: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """Causal attention (``causal=False``: every query attends every
    key, as an encoder-decoder's cross-attention does). q: (B,S,H,Dh);
    k,v: (B,Skv,Hkv,Dh[v]) -> (B,S,H,Dv).

    ``prefix``: the first ``prefix`` positions (a vlm's image tokens)
    attend each other both ways, a prefix-LM mask: after the causal and
    window terms, ``mask |= (q_pos < prefix) & (k_pos < prefix)``, as the
    reference applies it. Not with the packed overrides below.

    ``q_offset``: position of q's first row within the KV sequence.
    Chunked prefill attends a chunk of queries against the whole
    workspace with ``q_offset=start``, so the causal and window masks
    see global positions. A 0-dim integer tensor is read on the device,
    as the reference's traced scalar is: the window's slab start is
    clamped there and its K/V blocks are gathered at device indices, so
    a CUDA graph of the call replays at any offset; the output equals
    that of the ``int`` offset of the same value bit for bit.

    ``q_positions`` / ``kv_positions`` (S,) / (Skv,) and ``q_segments`` /
    ``kv_segments``, integer tensors, all four or none: per-token
    overrides for several sequences packed into one call. The mask is
    then ``seg_q == seg_kv & pos_q >= pos_kv [& pos_q - pos_kv <
    window]``, so a token attends its own segment only; padding takes
    position -1 and segments -2 (queries) and -1 (keys), which never
    match. There is no window slab (positions need not grow along the
    buffer) and ``q_offset`` is ignored. A fully masked kv block leaves
    every row's result exactly as it is without that block (before a
    row's first live block its sums are later scaled by exactly 0), so
    a segment's rows equal an unpacked call's that groups the same
    entries into the same kv blocks (segment bases aligned to
    ``kv_block``).
    """
    B, S, H, Dh = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    Dv = v.shape[-1]
    G = H // Hkv
    scale = Dh ** -0.5
    packed = q_positions is not None
    if packed != (kv_positions is not None) or packed != (
            q_segments is not None) or packed != (kv_segments is not None):
        raise ValueError("flash_attention: pass q_positions, kv_positions, "
                         "q_segments and kv_segments together")
    if packed and prefix is not None:
        raise ValueError("flash_attention: a prefix with the packed segment "
                         "overrides is unsupported")
    traced = isinstance(q_offset, torch.Tensor)
    if not traced:
        q_offset = int(q_offset)
    q_block = min(q_block, S)
    kv_block = min(kv_block, Skv)
    S0, Skv0 = S, Skv
    pad_q = (-S) % q_block
    pad_kv = (-Skv) % kv_block
    pad = torch.nn.functional.pad
    if pad_q:
        q = pad(q, (0, 0, 0, 0, 0, pad_q))
        S += pad_q
        if packed:
            q_positions = pad(q_positions, (0, pad_q), value=-1)
            q_segments = pad(q_segments, (0, pad_q), value=-2)
    if pad_kv:
        k = pad(k, (0, 0, 0, 0, 0, pad_kv))
        v = pad(v, (0, 0, 0, 0, 0, pad_kv))
        Skv += pad_kv
        if packed:
            kv_positions = pad(kv_positions, (0, pad_kv), value=-1)
            kv_segments = pad(kv_segments, (0, pad_kv), value=-1)
    nq = S // q_block
    qr = scaled(q.reshape(B, nq, q_block, Hkv, G, Dh), scale)

    if window is not None and causal and not packed:
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
        q_start = q_offset + qi * q_block
        if packed:
            rows = slice(qi * q_block, (qi + 1) * q_block)
            q_pos, q_seg = q_positions[rows], q_segments[rows]
        else:
            q_pos = q_start + torch.arange(q_block, device=dev)
        if slab == Skv:
            start = 0
        elif traced:
            start = torch.clamp(q_start + q_block - slab, 0, Skv - slab)
        else:
            start = min(max(q_start + q_block - slab, 0), Skv - slab)
        m = torch.full((B, Hkv, G, q_block, 1), NEG_INF, device=dev)
        l = torch.zeros((B, Hkv, G, q_block, 1), device=dev)
        acc = torch.zeros((B, Hkv, G, q_block, Dv), device=dev)
        for j in range(nkv):
            lo = start + j * kv_block
            k_pos = lo + torch.arange(kv_block, device=dev)
            if isinstance(lo, torch.Tensor):
                kj = k.index_select(1, k_pos)
                vj = v.index_select(1, k_pos)
            else:
                kj = k[:, lo:lo + kv_block]
                vj = v[:, lo:lo + kv_block]
            if packed:
                k_seg = kv_segments[lo:lo + kv_block]
                k_pos = kv_positions[lo:lo + kv_block]
            s = _f32_einsum("bqhgd,bkhd->bhgqk", qblk, kj)
            if causal:
                mask = q_pos[:, None] >= k_pos[None, :]
            else:
                mask = torch.ones((q_block, kv_block), dtype=torch.bool,
                                  device=dev)
            if window is not None:
                mask &= q_pos[:, None] - k_pos[None, :] < window
            if packed:
                mask &= q_seg[:, None] == k_seg[None, :]
            if prefix is not None:
                # bidirectional attention inside the (image) prefix
                mask |= (q_pos[:, None] < prefix) & (k_pos[None, :] < prefix)
            if pad_kv and not packed:
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
                     window: Optional[int] = None,
                     scale: Optional[float] = None) -> torch.Tensor:
    """One-token decode. q: (B,1,H,Dh); caches: (B,Skv,Hkv,Dh[v]).

    cache_len: (B,) or scalar, the number of valid cache positions.
    Scores are formed in the operands' promoted dtype (bf16 x bf16 gives
    bf16 scores, as jnp's einsum does) and softmaxed in float32.
    """
    B, _, H, Dh = q.shape
    Skv, Hkv = k_cache.shape[1], k_cache.shape[2]
    G = H // Hkv
    if scale is None:
        scale = Dh ** -0.5
    qr = scaled(q.reshape(B, Hkv, G, Dh), scale)
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


def gather_pages(pool: torch.Tensor, block: torch.Tensor) -> torch.Tensor:
    """Per-slot linear views of a paged pool.

    pool: (P, page, ...) physical pages; block: (B, NB) int32 block
    table -> (B, NB*page, ...), where row b's position p reads
    ``pool[block[b, p // page], p % page]``. Empty entries point at the
    trash page (0); consumers mask positions ``>= cache_len``.
    """
    P, page = pool.shape[:2]
    B, NB = block.shape
    flat = pool.reshape((P * page,) + tuple(pool.shape[2:]))
    idx = (block.long() * page)[:, :, None] + torch.arange(
        page, device=block.device)
    return flat[idx.reshape(B, NB * page)]


def scatter_token_pages(pool: torch.Tensor, block: torch.Tensor,
                        idx: torch.Tensor, val: torch.Tensor) -> torch.Tensor:
    """Write one token's K or V through the block table, in place.

    pool: (P, page, ...); block: (B, NB); idx: (B,) logical position to
    write; val: (B, ...). Dead slots keep ``idx`` at 0 with an all-trash
    block row, so their writes land on the trash page. Returns ``pool``.
    (The reference returns a new array.)
    """
    page = pool.shape[1]
    NB = block.shape[1]
    col = torch.clamp(idx.long() // page, 0, NB - 1)
    phys = torch.take_along_dim(block.long(), col[:, None], dim=1)[:, 0]
    pool[phys, idx.long() % page] = val.to(pool.dtype)
    return pool
