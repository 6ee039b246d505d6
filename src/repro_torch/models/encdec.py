"""Encoder-decoder transformer (the seamless-m4t backbone).

Counterpart of ``repro.models.encdec``. The audio frontend is a stub, as
there: callers pass precomputed frame embeddings ``frames`` (B, S_src,
D). The encoder runs the decoder-only LM's layer (``models/lm.py``'s
attention and MLP blocks, whose prefill attention is causal, as the
reference's ``attn_forward`` is) over the frames and norms the result
into the memory; each decoder layer adds a cross-attention block (q, k,
v, o) between its self-attention and its MLP, attending the memory
unmasked (``flash_attention(causal=False)``) in a prefill and through
``decode_attention`` with a per-row ``src_len`` mask in a decode step.
Every projection is a LUT-Q leaf under the config's policy, the tied
readout (``embed.table``) included. The reference scans over stacked
``encoder`` / ``decoder`` axes; here they are ``nn.ModuleList``s walked
by a Python loop, and ``nn/tree.py`` maps a per-layer path back to the
reference's stacked one (``decoder/xattn/q/kernel``).

Caches, one dict a decoder layer in a list:
  slot   ``{"layers": [{"k", "v", "xk", "xv"}], "len", "src_len"}``:
         self-attention K/V (B, max_len, Hkv, dh) and the cross K/V of
         the memory (B, src_len, Hkv, dh), right-padded to the engine's
         source width; ``src_len`` (B,) counts each row's real frames;
  paged  ``{"pool": [{"k", "v"}], "xk": [...], "xv": [...], "block",
         "len", "src_len"}``: the growing self-attention K/V in the page
         pool, the cross K/V a dense per-slot slab a layer (it depends on
         the request's frames, so no two requests share it).
Both hold ``cfg.dtype`` values, never int8: the reference's encdec
caches never quantize, so the self-attention here runs at 16-bit KV
whatever ``cfg.kv_cache_bits`` says.

Training (``encdec_loss``) runs the decoder over the whole target with
the tied readout's logits and the masked CE of ``models/lm.py``; with
``cfg.remat`` each encoder and decoder layer is recomputed in the
backward.

Entry points:
  init_encdec          random model from a generator
  encode               frames -> memory (B, S_src, D)
  encdec_forward       frames + target -> logits (training forward)
  encdec_loss          the training loss of a batch
  cross_kv             memory -> a layer's cross K/V
  cross_attn_apply     a layer's cross-attention
  encdec_prefill       frames + target prompt -> last logits + slot cache
  init_encdec_cache    an empty slot cache
  encdec_decode        (B, W) tokens against the slot cache (W = 1: a
                       decode step; W = k + 1: a speculative verify
                       window, each row the bits of W chained steps)
  init_paged_encdec_cache, encdec_paged_decode, encdec_paged_splice
                       the paged engine's cache, decode and admission
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch
from torch import nn

from repro_torch.kernels.build import ROW_STABLE_M
from repro_torch.models.config import ModelConfig
from repro_torch.models.lm import (Layer, _embed_tokens, _head,
                                   _join, _lin, _norm_rows, _positions,
                                   attn_decode, attn_forward, attn_init,
                                   last_real_slice, masked_ce, mlp_apply,
                                   mlp_init, paged_attn_decode, run_layer)
from repro_torch.nn.attention import decode_attention, flash_attention
from repro_torch.nn.linear import embedding_init, linear_apply, linear_init
from repro_torch.nn.norms import rmsnorm_apply, rmsnorm_init


class CrossAttention(nn.Module):
    def __init__(self, q, k, v, o):
        super().__init__()
        self.q, self.k, self.v, self.o = q, k, v, o


class DecoderLayer(Layer):
    """A decoder layer: the LM layer's ``ln1`` / ``attn`` / ``ln2`` /
    ``mlp`` plus ``ln_x`` and the cross-attention ``xattn``."""

    def __init__(self, ln1, ln2, attn, mlp, ln_x, xattn):
        super().__init__(ln1, ln2, attn, mlp=mlp)
        self.ln_x, self.xattn = ln_x, xattn


class EncDec(nn.Module):
    """State-dict keys follow the reference's pytree paths:
    ``embed.table``, ``encoder.<i>.attn.q.kernel``,
    ``decoder.<i>.xattn.k.kernel``, ``decoder.<i>.ln_x.scale``,
    ``enc_norm.scale``, ``final_norm.scale``."""

    def __init__(self, embed, encoder, decoder, enc_norm, final_norm):
        super().__init__()
        self.embed = embed
        self.encoder = nn.ModuleList(encoder)
        self.decoder = nn.ModuleList(decoder)
        self.enc_norm = enc_norm
        self.final_norm = final_norm


def _check(cfg: ModelConfig):
    if cfg.family != "encdec":
        raise ValueError(f"models/encdec serves the encdec family, not "
                         f"{cfg.family!r} (config {cfg.name!r})")


def _self_cfg(cfg: ModelConfig) -> ModelConfig:
    """The config of the self-attention blocks: 16-bit KV (the encdec
    caches hold ``cfg.dtype`` values, as the reference's)."""
    return cfg if cfg.kv_cache_bits != 8 else cfg.replace(kv_cache_bits=16)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def cross_attn_init(gen, cfg: ModelConfig, device=None) -> CrossAttention:
    dh = cfg.resolved_head_dim
    return CrossAttention(
        linear_init(gen, cfg.d_model, cfg.n_heads * dh, device=device),
        linear_init(gen, cfg.d_model, cfg.n_kv_heads * dh, device=device),
        linear_init(gen, cfg.d_model, cfg.n_kv_heads * dh, device=device),
        linear_init(gen, cfg.n_heads * dh, cfg.d_model, device=device))


def _enc_layer_init(gen, cfg: ModelConfig, device=None) -> Layer:
    return Layer(rmsnorm_init(cfg.d_model, device=device),
                 rmsnorm_init(cfg.d_model, device=device),
                 attn_init(gen, cfg, device=device),
                 mlp=mlp_init(gen, cfg, device=device))


def _dec_layer_init(gen, cfg: ModelConfig, device=None) -> DecoderLayer:
    return DecoderLayer(rmsnorm_init(cfg.d_model, device=device),
                        rmsnorm_init(cfg.d_model, device=device),
                        attn_init(gen, cfg, device=device),
                        mlp_init(gen, cfg, device=device),
                        rmsnorm_init(cfg.d_model, device=device),
                        cross_attn_init(gen, cfg, device=device))


def n_encoder(cfg: ModelConfig) -> int:
    """Encoder layers (``enc_layers``, else ``n_layers``, as the
    reference)."""
    return cfg.enc_layers or cfg.n_layers


def init_encdec(gen: Optional[torch.Generator], cfg: ModelConfig,
                device=None) -> EncDec:
    """Random fp32 parameters from ``gen`` (None: unseeded, e.g. on the
    meta device as a skeleton to load weights into)."""
    _check(cfg)
    embed = embedding_init(gen, cfg.vocab, cfg.d_model, device=device)
    encoder = [_enc_layer_init(gen, cfg, device)
               for _ in range(n_encoder(cfg))]
    decoder = [_dec_layer_init(gen, cfg, device)
               for _ in range(cfg.n_layers)]
    return EncDec(embed, encoder, decoder,
                  rmsnorm_init(cfg.d_model, device=device),
                  rmsnorm_init(cfg.d_model, device=device))


# ---------------------------------------------------------------------------
# encoder and cross-attention
# ---------------------------------------------------------------------------

def _remat(cfg: ModelConfig) -> bool:
    """Whether each encoder and decoder layer is recomputed in the
    backward: under autograd with ``cfg.remat``, whatever the policy,
    as the reference's ``jax.checkpoint(body) if cfg.remat``."""
    return cfg.remat and torch.is_grad_enabled()


def _enc_layer(layer: Layer, cfg: ModelConfig, h, positions):
    h = h + attn_forward(layer.attn, cfg, rmsnorm_apply(layer.ln1, h),
                         positions)[0]
    return h + mlp_apply(layer.mlp, cfg, rmsnorm_apply(layer.ln2, h))


def encode(model: EncDec, cfg: ModelConfig, frames: torch.Tensor
           ) -> torch.Tensor:
    """frames (B, S_src, D), precomputed embeddings -> memory (B, S_src,
    D) in ``cfg.dtype``. Under autograd the gradient reaches the
    encoder's masters (and ``frames``, where they require it)."""
    h = frames.to(cfg.dtype)
    positions = torch.arange(h.shape[1], device=h.device)[None, :]
    remat = _remat(cfg)
    for layer in model.encoder:
        h = run_layer(_enc_layer, remat, layer, cfg, h, positions)
    return rmsnorm_apply(model.enc_norm, h)


def cross_kv(p: CrossAttention, cfg: ModelConfig, memory: torch.Tensor):
    """A layer's cross K/V of the memory: two (B, S_src, Hkv, dh)."""
    B, Sm, _ = memory.shape
    dh = cfg.resolved_head_dim
    k = _lin(p.k, cfg, memory).reshape(B, Sm, cfg.n_kv_heads, dh)
    v = _lin(p.v, cfg, memory).reshape(B, Sm, cfg.n_kv_heads, dh)
    return k, v


def cross_attn_apply(p: CrossAttention, cfg: ModelConfig, x, k, v, *,
                     src_len=None):
    """Cross-attention of x (B, S, D) over the memory's K/V. ``src_len``:
    each row's count of real memory positions (B,) for a one-token step
    against a right-padded cross K/V (None: all of them)."""
    B, S, _ = x.shape
    dh = cfg.resolved_head_dim
    q = _lin(p.q, cfg, x).reshape(B, S, cfg.n_heads, dh)
    if S == 1:
        if src_len is None:
            src_len = torch.full((B,), k.shape[1], dtype=torch.int32,
                                 device=x.device)
        o = decode_attention(q, k, v, src_len)
    else:
        o = flash_attention(q, k, v, causal=False, q_block=cfg.attn_q_block,
                            kv_block=cfg.attn_kv_block)
    return linear_apply(p.o, o.reshape(B, S, -1), backend=cfg.kernel_backend,
                        act_bits=cfg.act_bits)


def _cross_window(p: CrossAttention, cfg: ModelConfig, x, k, v, src_len):
    """W-token cross-attention of a decode window: the products batch
    over the window (at most ``ROW_STABLE_M`` rows a product), the
    attention replays the one-token branch per position, so each row has
    the bits of a one-token step (the reference's
    ``_cross_attn_window``)."""
    B, W, _ = x.shape
    dh = cfg.resolved_head_dim
    q = _lin(p.q, cfg, x, ROW_STABLE_M).reshape(B, W, cfg.n_heads, dh)
    o = _join([decode_attention(q[:, i:i + 1].contiguous(), k, v, src_len)
               for i in range(W)])
    return _lin(p.o, cfg, o.reshape(B, W, -1), ROW_STABLE_M)


# ---------------------------------------------------------------------------
# prefill and the slot cache
# ---------------------------------------------------------------------------

def _dec_layer(layer: DecoderLayer, cfg: ModelConfig, h, positions, memory):
    """One decoder layer over the whole target: (h, {"k", "v", "xk",
    "xv"}), the layer's self-attention K/V and its cross K/V."""
    xk, xv = cross_kv(layer.xattn, cfg, memory)
    a, c = attn_forward(layer.attn, cfg, rmsnorm_apply(layer.ln1, h),
                        positions)
    h = h + a
    h = h + cross_attn_apply(layer.xattn, cfg, rmsnorm_apply(layer.ln_x, h),
                             xk, xv)
    h = h + mlp_apply(layer.mlp, cfg, rmsnorm_apply(layer.ln2, h))
    return h, {"k": c["k"], "v": c["v"], "xk": xk, "xv": xv}


def _dec_layer_train(layer: DecoderLayer, cfg: ModelConfig, h, positions,
                     memory):
    return _dec_layer(layer, cfg, h, positions, memory)[0]


def encdec_forward(model: EncDec, cfg: ModelConfig, frames, tokens
                   ) -> torch.Tensor:
    """The training forward: encode ``frames``, run the decoder over the
    whole target ``tokens`` (B, St) with causal self-attention and
    unmasked cross-attention over the memory; logits (B, St, V) of the
    tied readout. With ``cfg.remat`` each encoder and decoder layer
    (its cross K/V included) is recomputed in the backward
    (``torch.utils.checkpoint``), as the reference's ``jax.checkpoint``
    of its scan bodies; only the residual stream between layers and the
    memory are kept."""
    _check(cfg)
    memory = encode(model, cfg, frames)
    h = _embed_tokens(model, cfg, tokens)
    positions = torch.arange(h.shape[1], device=h.device)[None, :]
    remat = _remat(cfg)
    for layer in model.decoder:
        h = run_layer(_dec_layer_train, remat, layer, cfg, h, positions,
                      memory)
    return _head(model, cfg, rmsnorm_apply(model.final_norm, h))


def encdec_loss(model: EncDec, cfg: ModelConfig, batch):
    """batch: frames (B, S_src, D), tokens (B, St), labels (B, St) (-100
    = ignore) -> (loss, {"loss"}): the masked CE over f32 logits
    (``lm.masked_ce``), as the reference's ``encdec_loss``. The readout
    decodes the tied table through the STE and multiplies with
    ``torch.matmul``, as the reference does outside any kernel."""
    logits = encdec_forward(model, cfg, batch["frames"], batch["tokens"])
    loss, _ = masked_ce(logits, batch["labels"])
    return loss, {"loss": loss}


def encdec_prefill(model: EncDec, cfg: ModelConfig, frames, tokens, *,
                   lengths=None):
    """Encode the frames, run the target prompt: (last logits (B, 1, V),
    cache). ``lengths``: per-stream real prompt lengths of right-padded
    tokens (logits from each stream's last real token; the causal
    decoder keeps padding out of the real positions). Frames are taken
    at face value: ``src_len`` is their width for every row (ragged
    sources are prefilled apart, each at its own width; see
    ``runtime/engine.py``)."""
    _check(cfg)
    memory = encode(model, cfg, frames)
    h = _embed_tokens(model, cfg, tokens)
    B, St, _ = h.shape
    positions = torch.arange(St, device=h.device)[None, :]
    caches = []
    for layer in model.decoder:
        h, c = _dec_layer(layer, cfg, h, positions, memory)
        caches.append(c)
    h_last = h[:, -1:] if lengths is None else last_real_slice(h, lengths)
    logits = _head(model, cfg, rmsnorm_apply(model.final_norm, h_last))
    if lengths is None:
        cache_len = torch.full((B,), St, dtype=torch.int32, device=h.device)
    else:
        cache_len = torch.as_tensor(lengths, device=h.device).to(torch.int32)
    src_len = torch.full((B,), memory.shape[1], dtype=torch.int32,
                         device=h.device)
    return logits, {"layers": caches, "len": cache_len, "src_len": src_len}


def init_encdec_cache(cfg: ModelConfig, batch: int, max_len: int,
                      src_len: int, *, device=None) -> Dict[str, Any]:
    """An empty slot cache of ``max_len`` self-attention and ``src_len``
    cross positions a row; every row's ``src_len`` is the full width."""
    _check(cfg)
    dh = cfg.resolved_head_dim

    def zeros(n):
        return torch.zeros((batch, n, cfg.n_kv_heads, dh), dtype=cfg.dtype,
                           device=device)

    return {"layers": [{"k": zeros(max_len), "v": zeros(max_len),
                        "xk": zeros(src_len), "xv": zeros(src_len)}
                       for _ in range(cfg.n_layers)],
            "len": torch.zeros((batch,), dtype=torch.int32, device=device),
            "src_len": torch.full((batch,), src_len, dtype=torch.int32,
                                  device=device)}


def encdec_decode(model: EncDec, cfg: ModelConfig, tokens, cache):
    """tokens: (B, W) -> (logits (B, W, V), cache with len + W). Each
    layer's self-attention K/V entries are written into the cache in
    place (``lm.attn_decode``); the cross K/V and ``src_len`` are read
    only."""
    _check(cfg)
    scfg = _self_cfg(cfg)
    B, W = tokens.shape
    h = _embed_tokens(model, cfg, tokens)
    pos = _positions(cache["len"], B, W, h.device)
    src_len = cache.get("src_len")
    for layer, c in zip(model.decoder, cache["layers"]):
        h = h + attn_decode(layer.attn, scfg, _norm_rows(layer.ln1, h), c,
                            pos)
        h = h + _cross_window(layer.xattn, cfg, _norm_rows(layer.ln_x, h),
                              c["xk"], c["xv"], src_len)
        h = h + mlp_apply(layer.mlp, cfg, _norm_rows(layer.ln2, h),
                          ROW_STABLE_M)
    logits = _head(model, cfg, _norm_rows(model.final_norm, h), ROW_STABLE_M)
    out = {"layers": cache["layers"], "len": cache["len"] + W}
    if src_len is not None:
        out["src_len"] = src_len
    return logits, out


# ---------------------------------------------------------------------------
# paged serving: self-attention K/V in the page pool, cross K/V a dense
# slab a slot
# ---------------------------------------------------------------------------
#
# The cross K/V depends on the request's frames, so it is never shared:
# it stays a (B, src_len, Hkv, dh) slab a layer while the growing
# self-attention K/V is paged. Pages hold cfg.dtype values (the slot
# cache never quantizes either), so a paged decode step gives the slot
# path's bits. A prompt is admitted through one bucket-padded
# ``encdec_prefill`` (the causal decoder keeps right-padding exact) and
# ``encdec_paged_splice``.


def init_paged_encdec_cache(cfg: ModelConfig, batch: int, n_pages: int,
                            page_size: int, n_blocks: int, src_len: int, *,
                            device=None) -> Dict[str, Any]:
    """Paged encdec cache: ``pool`` (one {"k", "v"} (P, page, Hkv, dh) a
    layer), ``xk`` / ``xv`` (one (B, src_len, Hkv, dh) slab a layer),
    ``block`` (B, NB), ``len`` and ``src_len`` (B,), all zero."""
    _check(cfg)
    dh = cfg.resolved_head_dim

    def zeros(*shape):
        return torch.zeros(shape + (cfg.n_kv_heads, dh), dtype=cfg.dtype,
                           device=device)

    def ints(*shape):
        return torch.zeros(shape, dtype=torch.int32, device=device)

    L = cfg.n_layers
    return {"pool": [{"k": zeros(n_pages, page_size),
                      "v": zeros(n_pages, page_size)} for _ in range(L)],
            "xk": [zeros(batch, src_len) for _ in range(L)],
            "xv": [zeros(batch, src_len) for _ in range(L)],
            "block": ints(batch, n_blocks), "len": ints(batch),
            "src_len": ints(batch)}


def encdec_paged_decode(model: EncDec, cfg: ModelConfig, tokens, cache):
    """tokens: (B, W) -> (logits (B, W, V), cache with len + W): the
    paged twin of :func:`encdec_decode`. Self-attention scatters each
    position's K/V through the block table and attends through it with
    ``ops.paged_attention`` (kernel 6 on the card); cross-attention
    replays the one-token branch per position against the slot's slab,
    masked by its ``src_len``. Reads ``len`` and ``src_len`` on the
    device only, so a CUDA graph of it replays for any lengths."""
    _check(cfg)
    scfg = _self_cfg(cfg)
    B, W = tokens.shape
    h = _embed_tokens(model, cfg, tokens)
    pos = _positions(cache["len"], B, W, h.device)
    for layer, pool, xk, xv in zip(model.decoder, cache["pool"], cache["xk"],
                                   cache["xv"]):
        h = h + paged_attn_decode(layer.attn, scfg, _norm_rows(layer.ln1, h),
                                  pool, cache["block"], pos)
        h = h + _cross_window(layer.xattn, cfg, _norm_rows(layer.ln_x, h),
                              xk, xv, cache["src_len"])
        h = h + mlp_apply(layer.mlp, cfg, _norm_rows(layer.ln2, h),
                          ROW_STABLE_M)
    logits = _head(model, cfg, _norm_rows(model.final_norm, h), ROW_STABLE_M)
    return logits, dict(cache, len=cache["len"] + W)


def encdec_paged_splice(cfg: ModelConfig, cache, prefill_layers: List[dict],
                        block_row, length, slot: int):
    """Commit one request's prefill to the paged cache, in place.

    ``prefill_layers``: the per-layer caches of a bucket-padded
    :func:`encdec_prefill` of one request (k, v (1, St, Hkv, dh); xk, xv
    (1, s, Hkv, dh)). Self-attention positions [0, ``length``) scatter
    through ``block_row`` (NB,); the padding positions write zeros to
    the trash page (many land on one entry, and only equal values make
    the result independent of the writes' order). The cross K/V fills
    the slot's row of each slab, zero past ``s``. ``length``: an int or
    a 0-dim tensor. The caller sets the slot's ``block``, ``len`` and
    ``src_len``. Returns ``cache``."""
    pool = cache["pool"]
    page = pool[0]["k"].shape[1]
    dev = pool[0]["k"].device
    row = torch.as_tensor(block_row, device=dev).long()
    NB = row.shape[0]
    St = prefill_layers[0]["k"].shape[1]
    pos = torch.arange(St, device=dev)
    valid = pos < torch.as_tensor(length, device=dev)
    phys = torch.where(valid, row[torch.clamp(pos // page, 0, NB - 1)], 0)
    off = pos % page
    live = valid[:, None, None]
    s = prefill_layers[0]["xk"].shape[1]
    for c, xk, xv, p in zip(pool, cache["xk"], cache["xv"], prefill_layers):
        for key in ("k", "v"):
            c[key][phys, off] = torch.where(live, p[key][0], 0).to(
                c[key].dtype)
        for slab, key in ((xk, "xk"), (xv, "xv")):
            slab[slot, :s] = p[key][0].to(slab.dtype)
            slab[slot, s:] = 0
    return cache
