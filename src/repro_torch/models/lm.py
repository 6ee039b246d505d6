"""Decoder-only transformer LM, dense path.

Counterpart of the dense path of ``repro.models.lm``: GQA attention with
an optional sliding window (SWA ring cache, optional int8 KV with bf16
scales), SwiGLU MLP, untied or tied readout. The reference scans over a
stacked layer axis; here the layers are an ``nn.ModuleList`` walked by a
Python loop, and the cache holds one dict per layer.

Entry points:
  lm_forward      (B, S) tokens -> logits (training forward) + aux
  lm_loss         next-token cross-entropy of a batch
  lm_prefill      (B, S) prompt -> last logits + per-layer K/V
  lm_decode_step  (B, 1) token  -> logits + updated cache
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.models.config import ModelConfig
from repro_torch.nn.attention import decode_attention, flash_attention
from repro_torch.nn.linear import (embedding_apply, embedding_init,
                                   embedding_logits, linear_apply,
                                   linear_init)
from repro_torch.nn.norms import rmsnorm_apply, rmsnorm_init
from repro_torch.nn.rotary import apply_rope


class Attention(nn.Module):
    def __init__(self, q, k, v, o):
        super().__init__()
        self.q, self.k, self.v, self.o = q, k, v, o


class MLP(nn.Module):
    def __init__(self, wi, wg, wo):
        super().__init__()
        self.wi, self.wg, self.wo = wi, wg, wo


class Layer(nn.Module):
    def __init__(self, ln1, ln2, attn, mlp):
        super().__init__()
        self.ln1, self.ln2, self.attn, self.mlp = ln1, ln2, attn, mlp


class LM(nn.Module):
    """State-dict keys follow the reference's pytree paths:
    ``embed.table``, ``layers.<i>.attn.q.kernel``, ``final_norm.scale``,
    ``lm_head.kernel``."""

    def __init__(self, embed, layers, final_norm, lm_head=None):
        super().__init__()
        self.embed = embed
        self.layers = nn.ModuleList(layers)
        self.final_norm = final_norm
        if lm_head is not None:
            self.lm_head = lm_head


def _check_dense(cfg: ModelConfig):
    if (cfg.family != "dense" or cfg.use_mla or cfg.n_experts
            or cfg.first_dense or cfg.n_prefix_tokens or cfg.qkv_bias
            or cfg.use_qk_norm):
        raise NotImplementedError(
            f"the port serves dense GQA attention without qkv bias or qk "
            f"norm so far (config {cfg.name!r}); see ROADMAP queue 1 "
            f"item 6")


# ---------------------------------------------------------------------------
# attention sub-block (GQA / SWA)
# ---------------------------------------------------------------------------

def attn_init(gen, cfg: ModelConfig, device=None) -> Attention:
    dh = cfg.resolved_head_dim
    return Attention(
        linear_init(gen, cfg.d_model, cfg.n_heads * dh, device=device),
        linear_init(gen, cfg.d_model, cfg.n_kv_heads * dh, device=device),
        linear_init(gen, cfg.d_model, cfg.n_kv_heads * dh, device=device),
        linear_init(gen, cfg.n_heads * dh, cfg.d_model, device=device))


def _qkv(p: Attention, cfg: ModelConfig, x, positions):
    B, S, _ = x.shape
    dh = cfg.resolved_head_dim
    kb, ab = cfg.kernel_backend, cfg.act_bits
    q = linear_apply(p.q, x, backend=kb,
                     act_bits=ab).reshape(B, S, cfg.n_heads, dh)
    k = linear_apply(p.k, x, backend=kb,
                     act_bits=ab).reshape(B, S, cfg.n_kv_heads, dh)
    v = linear_apply(p.v, x, backend=kb,
                     act_bits=ab).reshape(B, S, cfg.n_kv_heads, dh)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def attn_forward(p: Attention, cfg: ModelConfig, x, positions):
    """Prefill attention. Returns (out, {"k", "v"})."""
    B, S, _ = x.shape
    q, k, v = _qkv(p, cfg, x, positions)
    o = flash_attention(q, k, v, window=cfg.window,
                        q_block=cfg.attn_q_block, kv_block=cfg.attn_kv_block)
    out = linear_apply(p.o, o.reshape(B, S, -1), backend=cfg.kernel_backend,
                       act_bits=cfg.act_bits)
    return out, {"k": k, "v": v}


def _kv_quant(t, bits):
    """Per-(batch, pos, head) symmetric int8 quant of KV entries."""
    amax = t.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp(amax, min=1e-8) / 127.0
    q = torch.clamp(torch.round(t / scale), -127, 127).to(torch.int8)
    return q, scale[..., 0].to(torch.bfloat16)


def attn_decode(p: Attention, cfg: ModelConfig, x, cache, cache_len):
    """One-token decode against this layer's cache.

    With SWA the cache is a ring of width ``window`` (slot = position %
    width). With ``kv_cache_bits=8`` it holds int8 K/V plus per-entry
    bf16 scales. The new entry is written into the cache tensors in
    place (the reference returns new arrays); the returned dict holds
    the same tensors.
    """
    B = x.shape[0]
    pos = torch.as_tensor(cache_len, device=x.device).reshape(-1)
    pos = pos.expand(B).reshape(B, 1)
    q, k, v = _qkv(p, cfg, x, pos)
    idx = pos[:, 0].long()
    eff = cache["k"].shape[1]
    quant = cfg.kv_cache_bits == 8
    if quant:
        k, k_s = _kv_quant(k, 8)
        v, v_s = _kv_quant(v, 8)
    ring = cfg.window is not None and eff <= cfg.window
    slot = idx % eff if ring else torch.clamp(idx, max=eff - 1)
    rows = torch.arange(B, device=x.device)
    kc, vc = cache["k"], cache["v"]
    kc[rows, slot] = k[:, 0].to(kc.dtype)
    vc[rows, slot] = v[:, 0].to(vc.dtype)
    new_cache = {"k": kc, "v": vc}
    if quant:
        ks, vs = cache["k_scale"], cache["v_scale"]
        ks[rows, slot] = k_s[:, 0]
        vs[rows, slot] = v_s[:, 0]
        new_cache.update(k_scale=ks, v_scale=vs)
        # a bf16 product, whatever the working dtype, as the reference
        kc = kc.to(torch.bfloat16) * ks[..., None]
        vc = vc.to(torch.bfloat16) * vs[..., None]
    if ring:
        filled = torch.clamp(idx + 1, max=eff)
        o = decode_attention(q, kc, vc, filled)  # all filled ring slots live
    else:
        o = decode_attention(q, kc, vc, idx + 1, window=cfg.window)
    out = linear_apply(p.o, o.reshape(B, 1, -1), backend=cfg.kernel_backend,
                       act_bits=cfg.act_bits)
    return out, new_cache


# ---------------------------------------------------------------------------
# MLP / layer
# ---------------------------------------------------------------------------

def mlp_init(gen, cfg: ModelConfig, device=None) -> MLP:
    return MLP(linear_init(gen, cfg.d_model, cfg.d_ff, device=device),
               linear_init(gen, cfg.d_model, cfg.d_ff, device=device),
               linear_init(gen, cfg.d_ff, cfg.d_model, device=device))


def silu(x):
    """``jax.nn.silu``: x * 1 / (1 + exp(-x)), each step rounded to the
    working dtype. ``torch.nn.functional.silu`` rounds once, which moves
    a third of bf16 outputs by an ulp."""
    return x * (1.0 / (1.0 + torch.exp(-x)))


def mlp_apply(p: MLP, cfg: ModelConfig, x):
    kb, ab = cfg.kernel_backend, cfg.act_bits
    h = (linear_apply(p.wi, x, backend=kb, act_bits=ab)
         * silu(linear_apply(p.wg, x, backend=kb, act_bits=ab)))
    return linear_apply(p.wo, h, backend=kb, act_bits=ab)


def layer_init(gen, cfg: ModelConfig, device=None) -> Layer:
    return Layer(rmsnorm_init(cfg.d_model, device=device),
                 rmsnorm_init(cfg.d_model, device=device),
                 attn_init(gen, cfg, device=device),
                 mlp_init(gen, cfg, device=device))


def layer_forward(p: Layer, cfg: ModelConfig, h, positions):
    """Returns (h, cache)."""
    a_out, cache = attn_forward(p.attn, cfg, rmsnorm_apply(p.ln1, h),
                                positions)
    h = h + a_out
    return h + mlp_apply(p.mlp, cfg, rmsnorm_apply(p.ln2, h)), cache


def layer_decode(p: Layer, cfg: ModelConfig, h, cache, cache_len):
    a_out, new_cache = attn_decode(p.attn, cfg, rmsnorm_apply(p.ln1, h),
                                   cache, cache_len)
    h = h + a_out
    return h + mlp_apply(p.mlp, cfg, rmsnorm_apply(p.ln2, h)), new_cache


# ---------------------------------------------------------------------------
# full model
# ---------------------------------------------------------------------------

def init_lm(gen: Optional[torch.Generator], cfg: ModelConfig,
            device=None) -> LM:
    """Random fp32 parameters from ``gen`` (None: unseeded, e.g. on the
    meta device as a skeleton to load weights into)."""
    _check_dense(cfg)
    embed = embedding_init(gen, cfg.vocab, cfg.d_model, device=device)
    layers = [layer_init(gen, cfg, device=device)
              for _ in range(cfg.n_layers)]
    final_norm = rmsnorm_init(cfg.d_model, device=device)
    head = (None if cfg.tie_embeddings
            else linear_init(gen, cfg.d_model, cfg.vocab, device=device))
    return LM(embed, layers, final_norm, head)


def _embed_tokens(model: LM, cfg: ModelConfig, tokens):
    h = embedding_apply(model.embed, tokens, dtype=cfg.dtype)
    return h * (cfg.d_model ** 0.5)


def _readout(model: LM, cfg: ModelConfig, h):
    h = rmsnorm_apply(model.final_norm, h)
    if cfg.tie_embeddings:
        return embedding_logits(model.embed, h, backend=cfg.kernel_backend)
    return linear_apply(model.lm_head, h, backend=cfg.kernel_backend)


def _layer_train(p: Layer, cfg: ModelConfig, h, positions):
    return layer_forward(p, cfg, h, positions)[0]


def lm_forward(model: LM, cfg: ModelConfig, tokens):
    """Full forward -> (logits (B, S, V), aux). tokens: (B, S).

    With ``cfg.remat`` each layer is recomputed in the backward pass
    (``torch.utils.checkpoint``), as the reference's ``remat_wrap``
    recomputes its scan body: only the residual stream between layers
    is kept. The dense family has no auxiliary loss (aux = 0).
    """
    _check_dense(cfg)
    remat = (cfg.remat and cfg.remat_policy != "none"
             and torch.is_grad_enabled())
    if remat and cfg.remat_policy != "full":
        raise NotImplementedError(
            f"remat_policy {cfg.remat_policy!r} is not ported yet; the "
            f"port recomputes whole layers ('full') or none")
    h = _embed_tokens(model, cfg, tokens)
    positions = torch.arange(h.shape[1], device=h.device)[None, :]
    for layer in model.layers:
        if remat:
            h = checkpoint(_layer_train, layer, cfg, h, positions,
                           use_reentrant=False)
        else:
            h = _layer_train(layer, cfg, h, positions)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    return _readout(model, cfg, h), aux


def lm_loss(model: LM, cfg: ModelConfig, batch: Dict[str, torch.Tensor], *,
            aux_weight: float = 0.01
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token CE over f32 logits. batch: tokens (B, S), labels (B, S)
    with -100 (any negative) = ignore. Returns (loss + aux_weight * aux,
    {"loss", "aux", "ntok"})."""
    logits, aux = lm_forward(model, cfg, batch["tokens"])
    labels = batch["labels"].long()
    logits = logits.float()
    mask = (labels >= 0).float()
    safe = torch.clamp(labels, min=0)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.take_along_dim(logits, safe[..., None], dim=-1)[..., 0]
    ce = (logz - gold) * mask
    ntok = torch.clamp(mask.sum(), min=1.0)
    loss = ce.sum() / ntok
    total = loss + aux_weight * aux
    return total, {"loss": loss, "aux": aux, "ntok": ntok}


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *, device=None
               ) -> Dict[str, Any]:
    """Per-layer decode cache: K/V (int8 + bf16 scales with
    ``kv_cache_bits=8``), a ring of the window's width under SWA."""
    _check_dense(cfg)
    dh = cfg.resolved_head_dim
    eff = min(max_len, cfg.window) if cfg.window else max_len
    kv_dt = torch.int8 if cfg.kv_cache_bits == 8 else cfg.dtype
    shape = (batch, eff, cfg.n_kv_heads, dh)

    def one():
        c = {"k": torch.zeros(shape, dtype=kv_dt, device=device),
             "v": torch.zeros(shape, dtype=kv_dt, device=device)}
        if cfg.kv_cache_bits == 8:
            for key in ("k_scale", "v_scale"):
                c[key] = torch.zeros(shape[:-1], dtype=torch.bfloat16,
                                     device=device)
        return c

    return {"layers": [one() for _ in range(cfg.n_layers)],
            "len": torch.zeros((batch,), dtype=torch.int32, device=device)}


def last_real_slice(h, lengths, offset: int = 0):
    """(B, 1, D) hidden states at each stream's last real token."""
    idx = offset + torch.as_tensor(lengths, device=h.device).long() - 1
    return torch.take_along_dim(h, idx[:, None, None], dim=1)


def lm_prefill(model: LM, cfg: ModelConfig, tokens, *, lengths=None):
    """Run the full prompt, return (last_logits (B, 1, V), cache).

    ``lengths``: per-stream real prompt lengths for right-padded
    batches; logits come from each stream's last real position and
    ``cache["len"]`` records them.
    """
    _check_dense(cfg)
    h = _embed_tokens(model, cfg, tokens)
    B, S, _ = h.shape
    positions = torch.arange(S, device=h.device)[None, :]
    if lengths is None:
        cache_len = torch.full((B,), S, dtype=torch.int32, device=h.device)
    else:
        cache_len = torch.as_tensor(lengths, device=h.device).to(torch.int32)
    caches = []
    for layer in model.layers:
        h, c = layer_forward(layer, cfg, h, positions)
        caches.append(c)
    h_last = h[:, -1:] if lengths is None else last_real_slice(h, lengths)
    return _readout(model, cfg, h_last), {"len": cache_len, "layers": caches}


def lm_decode_step(model: LM, cfg: ModelConfig, token, cache):
    """token: (B, 1) -> (logits (B, 1, V), cache with len + 1)."""
    _check_dense(cfg)
    h = _embed_tokens(model, cfg, token)
    cache_len = cache["len"]
    new_caches = []
    for layer, c in zip(model.layers, cache["layers"]):
        h, c = layer_decode(layer, cfg, h, c, cache_len)
        new_caches.append(c)
    logits = _readout(model, cfg, h)
    return logits, {"layers": new_caches, "len": cache_len + 1}
