"""Decoder-only transformer LM, dense, MoE and vlm families.

Counterpart of the dense, MoE and vlm paths of ``repro.models.lm``. Attention
is GQA, with an optional sliding window (SWA ring cache, optional int8
KV with bf16 scales), an optional bias on q, k and v (added after the
product, cast to its dtype) and optional qk-norm (RMSNorm over the head
dim, before RoPE); or, under ``cfg.use_mla``, multi-head latent
attention (``nn/mla.py``: expanded prefill, absorbed one-token decode
against a latent cache). The feed-forward block is a SwiGLU MLP or a
top-k MoE (``nn/moe.py``; prefill at ``cfg.capacity_factor``, one-token
decode at ``max(cf, 2.0)``), with ``cfg.first_dense`` leading layers of
dense MLP (``prefix_layers``, as deepseek's); the readout is untied or
tied. A vlm config (paligemma) puts ``prefix_embeds`` (B, P, D), the
precomputed image embeddings of a stubbed frontend, in front of the
text: cast to the working dtype, unscaled, at positions 0 .. P - 1
(RoPE runs over prefix and text alike), attended both ways inside the
prefix (``flash_attention(prefix=P)``); a prefill's ``lengths`` count
text tokens and its cache's ``len`` counts the P prefix slots too, so
decode sees a longer cache and nothing else. The reference scans over a
stacked layer axis; here the layers are an ``nn.ModuleList`` walked by a
Python loop, the prefix layers first, and the cache holds one dict per
layer in that order.

Entry points:
  lm_forward      (B, S) tokens [+ prefix] -> logits (training
                  forward) + aux
  lm_loss         next-token cross-entropy of a batch (``masked_ce``,
                  which every family's loss shares)
  lm_prefill      (B, S) prompt [+ prefix] -> last logits + per-layer K/V
  lm_decode       (B, W) tokens -> logits + updated cache (W = 1: a
                  decode step; W = k + 1: a speculative verify window)
and the paged-KV entry points of the engine (``lm_paged_*``, below).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.device import scalar_like
from repro_torch.models.config import ModelConfig
from repro_torch.kernels import ops
from repro_torch.kernels.build import ROW_STABLE_M
from repro_torch.nn.attention import (decode_attention, flash_attention,
                                      gather_pages, scaled,
                                      scatter_token_pages)
from repro_torch.nn.linear import (embedding_apply, embedding_init,
                                   embedding_logits, linear_apply,
                                   linear_init, silu)
from repro_torch.nn.mla import mla_decode, mla_forward, mla_init
from repro_torch.nn.moe import moe_apply, moe_init
from repro_torch.nn.norms import rmsnorm_apply, rmsnorm_init
from repro_torch.nn.rotary import apply_rope


class Attention(nn.Module):
    def __init__(self, q, k, v, o, q_norm=None, k_norm=None):
        super().__init__()
        self.q, self.k, self.v, self.o = q, k, v, o
        if q_norm is not None:
            self.q_norm, self.k_norm = q_norm, k_norm


class MLP(nn.Module):
    def __init__(self, wi, wg, wo):
        super().__init__()
        self.wi, self.wg, self.wo = wi, wg, wo


class Layer(nn.Module):
    """``mlp`` (dense) or ``moe`` (a MoE layer), as the reference names
    the layer's feed-forward block; ``attn`` an :class:`Attention` or,
    under ``cfg.use_mla``, an :class:`~repro_torch.nn.mla.MLA`."""

    def __init__(self, ln1, ln2, attn, mlp=None, moe=None):
        super().__init__()
        self.ln1, self.ln2, self.attn = ln1, ln2, attn
        if moe is not None:
            self.moe = moe
        else:
            self.mlp = mlp


class LM(nn.Module):
    """State-dict keys follow the reference's pytree paths:
    ``embed.table``, ``layers.<i>.attn.q.kernel``, ``final_norm.scale``,
    ``lm_head.kernel``; with ``cfg.first_dense`` the leading dense
    layers are ``prefix_layers.<i>....`` (the reference's unstacked
    ``prefix_layers/<i>`` dicts) and ``layers`` holds the other
    ``n_layers - first_dense``."""

    def __init__(self, embed, layers, final_norm, lm_head=None,
                 prefix_layers=()):
        super().__init__()
        self.embed = embed
        if prefix_layers:
            self.prefix_layers = nn.ModuleDict(
                {str(i): layer for i, layer in enumerate(prefix_layers)})
        self.layers = nn.ModuleList(layers)
        self.final_norm = final_norm
        if lm_head is not None:
            self.lm_head = lm_head


def n_stacked(cfg: ModelConfig) -> int:
    """Layers of the stack (``layers``): those after the prefix layers."""
    return cfg.n_layers - cfg.first_dense


def all_layers(model: LM):
    """The layers in execution order: the prefix layers, then the
    stack (the order of a cache's per-layer list)."""
    prefix = getattr(model, "prefix_layers", None)
    return (list(prefix.values()) if prefix is not None else []) + list(
        model.layers)


#: families the decoder-only entry points refuse, and the module that
#: serves each (through ``models/api``)
_ELSEWHERE = {"encdec": ("an encoder-decoder", "models/encdec"),
              "hybrid": ("a hybrid", "models/zamba"),
              "ssm": ("an ssm (attention-free)", "models/rwkv")}


def _check_family(cfg: ModelConfig):
    """The decoder-only entry points serve the dense, MoE and vlm
    families; an encoder-decoder config goes through ``models/encdec.py``,
    a hybrid one through ``models/zamba.py`` and an ssm one through
    ``models/rwkv.py`` (the first two reuse this module's blocks, none of
    them these entry points)."""
    if cfg.family in _ELSEWHERE:
        what, where = _ELSEWHERE[cfg.family]
        raise ValueError(f"config {cfg.name!r} is {what}: the decoder-only "
                         f"LM entry points refuse it (serve it through "
                         f"models/api, which dispatches it to {where})")
    if cfg.family not in ("dense", "moe", "vlm"):
        raise ValueError(f"unknown model family {cfg.family!r} (config "
                         f"{cfg.name!r})")


def _check_paged(cfg: ModelConfig):
    """The paged entry points serve what ``api.paged_supported`` admits:
    dense GQA attention, no experts or prefix layers (the reference keeps
    MoE and MLA on the slot path)."""
    _check_family(cfg)
    if (cfg.family != "dense" or cfg.n_experts or cfg.use_mla
            or cfg.first_dense):
        raise ValueError(f"paged KV unsupported for family={cfg.family} "
                         f"(use api.paged_supported to gate)")


# ---------------------------------------------------------------------------
# attention sub-block (GQA / SWA)
# ---------------------------------------------------------------------------

def attn_init(gen, cfg: ModelConfig, device=None) -> Attention:
    """q, k, v (each with a bias under ``cfg.qkv_bias``, zero at init, as
    the reference's), o and, under ``cfg.use_qk_norm``, the qk-norms."""
    dh = cfg.resolved_head_dim
    norms = ((rmsnorm_init(dh, device=device), rmsnorm_init(dh, device=device))
             if cfg.use_qk_norm else (None, None))
    qkv = dict(bias=cfg.qkv_bias, device=device)
    return Attention(
        linear_init(gen, cfg.d_model, cfg.n_heads * dh, **qkv),
        linear_init(gen, cfg.d_model, cfg.n_kv_heads * dh, **qkv),
        linear_init(gen, cfg.d_model, cfg.n_kv_heads * dh, **qkv),
        linear_init(gen, cfg.n_heads * dh, cfg.d_model, device=device),
        *norms)


def _rows(fn, x, chunk: Optional[int]):
    """``fn(x)`` for x (B, W, D), or, where its B * W rows exceed
    ``chunk``, ``fn`` over as many whole positions of x as fit in
    ``chunk`` rows (one position, B rows, where B alone is wider),
    joined."""
    B, W, D = x.shape
    per = W if chunk is None else max(1, chunk // B)
    if per >= W:
        return fn(x)
    xt = x.transpose(0, 1)
    y = torch.cat([fn(xt[i:i + per].reshape(-1, 1, D))
                   for i in range(0, W, per)])
    return y.reshape(W, B, -1).transpose(0, 1)


def _lin(p, cfg: ModelConfig, x, chunk: Optional[int] = None):
    """A product of the model at its backend and activation bits."""
    return _rows(lambda t: linear_apply(p, t, backend=cfg.kernel_backend,
                                        act_bits=cfg.act_bits), x, chunk)


def _qkv(p: Attention, cfg: ModelConfig, x, positions,
         chunk: Optional[int] = None):
    B, S, _ = x.shape
    dh = cfg.resolved_head_dim
    q = _lin(p.q, cfg, x, chunk).reshape(B, S, cfg.n_heads, dh)
    k = _lin(p.k, cfg, x, chunk).reshape(B, S, cfg.n_kv_heads, dh)
    v = _lin(p.v, cfg, x, chunk).reshape(B, S, cfg.n_kv_heads, dh)
    if cfg.use_qk_norm:
        q = rmsnorm_apply(p.q_norm, q)
        k = rmsnorm_apply(p.k_norm, k)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def attn_forward(p: Attention, cfg: ModelConfig, x, positions, *,
                 prefix: Optional[int] = None):
    """Prefill attention (the first ``prefix`` positions bidirectional).
    Returns (out, {"k", "v"})."""
    B, S, _ = x.shape
    q, k, v = _qkv(p, cfg, x, positions)
    o = flash_attention(q, k, v, window=cfg.window, prefix=prefix,
                        q_block=cfg.attn_q_block, kv_block=cfg.attn_kv_block)
    out = linear_apply(p.o, o.reshape(B, S, -1), backend=cfg.kernel_backend,
                       act_bits=cfg.act_bits)
    return out, {"k": k, "v": v}


def _kv_quant(t, bits):
    """Per-(batch, pos, head) symmetric int8 quant of KV entries."""
    amax = t.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp(amax, min=1e-8) / scalar_like(127.0, t)
    q = torch.clamp(torch.round(t / scale), -127, 127).to(torch.int8)
    return q, scale[..., 0].to(torch.bfloat16)


# ---------------------------------------------------------------------------
# MLP / layer
# ---------------------------------------------------------------------------

def mlp_init(gen, cfg: ModelConfig, device=None) -> MLP:
    return MLP(linear_init(gen, cfg.d_model, cfg.d_ff, device=device),
               linear_init(gen, cfg.d_model, cfg.d_ff, device=device),
               linear_init(gen, cfg.d_ff, cfg.d_model, device=device))


def mlp_apply(p: MLP, cfg: ModelConfig, x, chunk: Optional[int] = None):
    h = _lin(p.wi, cfg, x, chunk) * silu(_lin(p.wg, cfg, x, chunk))
    return _lin(p.wo, cfg, h, chunk)


def ffn_apply(p: Layer, cfg: ModelConfig, x, chunk: Optional[int] = None,
              *, decode: bool = False):
    """The layer's feed-forward block: (out, aux). A MoE layer routes at
    ``cfg.capacity_factor`` (prefill, training) or, for a one-token
    decode step, at ``max(cf, 2.0)``, as the reference's
    ``layer_decode``; a dense MLP has aux 0."""
    if hasattr(p, "moe"):
        cf = (max(cfg.capacity_factor, 2.0) if decode
              else cfg.capacity_factor)
        return moe_apply(p.moe, x, top_k=cfg.top_k, capacity_factor=cf,
                         backend=cfg.kernel_backend, act_bits=cfg.act_bits)
    return (mlp_apply(p.mlp, cfg, x, chunk),
            torch.zeros((), dtype=torch.float32, device=x.device))


def _mla_dims(cfg: ModelConfig) -> Dict[str, int]:
    return dict(n_heads=cfg.n_heads, kv_lora=cfg.kv_lora,
                qk_nope=cfg.qk_nope, qk_rope=cfg.qk_rope, v_head=cfg.v_head)


def layer_init(gen, cfg: ModelConfig, device=None, *, moe: bool = True
               ) -> Layer:
    """A layer of ``cfg``: a MoE feed-forward block where the config has
    experts and ``moe`` (False for a leading dense layer: an MLP of
    ``cfg.d_ff``, as the reference's prefix layers)."""
    if cfg.n_experts and moe:
        ffn = {"moe": moe_init(gen, cfg.d_model, cfg.d_ff, cfg.n_experts,
                               n_shared=cfg.n_shared_experts,
                               d_ff_shared=cfg.d_ff_shared, device=device)}
    else:
        ffn = {"mlp": mlp_init(gen, cfg, device=device)}
    if cfg.use_mla:
        attn = mla_init(gen, cfg.d_model, **_mla_dims(cfg), device=device)
    else:
        attn = attn_init(gen, cfg, device=device)
    return Layer(rmsnorm_init(cfg.d_model, device=device),
                 rmsnorm_init(cfg.d_model, device=device), attn, **ffn)


def layer_forward(p: Layer, cfg: ModelConfig, h, positions, *,
                  prefix: Optional[int] = None):
    """Returns (h, cache, aux)."""
    a_in = rmsnorm_apply(p.ln1, h)
    if cfg.use_mla:
        a_out, cache = mla_forward(p.attn, a_in, positions, **_mla_dims(cfg),
                                   backend=cfg.kernel_backend,
                                   act_bits=cfg.act_bits)
    else:
        a_out, cache = attn_forward(p.attn, cfg, a_in, positions,
                                    prefix=prefix)
    h = h + a_out
    m_out, aux = ffn_apply(p, cfg, rmsnorm_apply(p.ln2, h))
    return h + m_out, cache, aux


# ---------------------------------------------------------------------------
# full model
# ---------------------------------------------------------------------------

def init_lm(gen: Optional[torch.Generator], cfg: ModelConfig,
            device=None) -> LM:
    """Random fp32 parameters from ``gen`` (None: unseeded, e.g. on the
    meta device as a skeleton to load weights into)."""
    _check_family(cfg)
    embed = embedding_init(gen, cfg.vocab, cfg.d_model, device=device)
    prefix = [layer_init(gen, cfg, device=device, moe=False)
              for _ in range(cfg.first_dense)]
    layers = [layer_init(gen, cfg, device=device)
              for _ in range(n_stacked(cfg))]
    final_norm = rmsnorm_init(cfg.d_model, device=device)
    head = (None if cfg.tie_embeddings
            else linear_init(gen, cfg.d_model, cfg.vocab, device=device))
    return LM(embed, layers, final_norm, head, prefix_layers=prefix)


def _embed_tokens(model: LM, cfg: ModelConfig, tokens, prefix_embeds=None):
    """The text's embeddings scaled by sqrt(d_model), in ``cfg.dtype``
    (the scale rounds to that dtype first, as jnp's weakly typed scalar
    does), with ``prefix_embeds`` (B, P, D), cast and unscaled, in
    front."""
    h = scaled(embedding_apply(model.embed, tokens, dtype=cfg.dtype),
               cfg.d_model ** 0.5)
    if prefix_embeds is not None:
        h = torch.cat([prefix_embeds.to(device=h.device, dtype=cfg.dtype),
                       h], dim=1)
    return h


def _prefix(cfg: ModelConfig, prefix_embeds) -> Optional[int]:
    """The bidirectional prefix's width: the config's, where the batch
    carries its embeddings (a text-only call on a vlm config has none)."""
    if prefix_embeds is None:
        return None
    if prefix_embeds.shape[1] != cfg.n_prefix_tokens:
        raise ValueError(f"prefix_embeds of {prefix_embeds.shape[1]} "
                         f"positions; config {cfg.name!r} takes "
                         f"{cfg.n_prefix_tokens}")
    return cfg.n_prefix_tokens


def _head(model: LM, cfg: ModelConfig, h, chunk: Optional[int] = None):
    """Logits of normed hidden states (the readout's product)."""
    if cfg.tie_embeddings:
        return _rows(lambda t: embedding_logits(
            model.embed, t, backend=cfg.kernel_backend), h, chunk)
    return _rows(lambda t: linear_apply(model.lm_head, t,
                                        backend=cfg.kernel_backend), h, chunk)


def _readout(model: LM, cfg: ModelConfig, h):
    return _head(model, cfg, rmsnorm_apply(model.final_norm, h))


def _layer_train(p: Layer, cfg: ModelConfig, h, positions, prefix=None):
    h, _, aux = layer_forward(p, cfg, h, positions, prefix=prefix)
    return h, aux


def remat_layers(cfg: ModelConfig) -> bool:
    """Whether the training forward recomputes each layer in the
    backward, as the reference's ``remat_wrap`` decides from
    ``cfg.remat`` and ``cfg.remat_policy``: only under autograd, and
    only the reference's ``"full"`` policy is ported."""
    remat = (cfg.remat and cfg.remat_policy != "none"
             and torch.is_grad_enabled())
    if remat and cfg.remat_policy != "full":
        raise NotImplementedError(
            f"remat_policy {cfg.remat_policy!r} is not ported yet; the "
            f"port recomputes whole layers ('full') or none")
    return remat


def run_layer(fn, remat: bool, *args):
    """``fn(*args)``; under ``remat`` through ``torch.utils.checkpoint``,
    which keeps only the inputs and recomputes ``fn`` in the backward."""
    if remat:
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def lm_forward(model: LM, cfg: ModelConfig, tokens, *, prefix_embeds=None):
    """Full forward -> (logits (B, P + S, V), aux). tokens: (B, S);
    ``prefix_embeds`` (B, P, D) a vlm's image prefix (P = 0 without).

    With ``cfg.remat`` each layer is recomputed in the backward pass
    (``torch.utils.checkpoint``), as the reference's ``remat_wrap``
    recomputes its scan body: only the residual stream between layers
    is kept (the prefix layers too, which the reference runs outside its
    remat'd scan). aux sums the MoE layers' load-balance losses (0 for
    the dense family).
    """
    _check_family(cfg)
    remat = remat_layers(cfg)
    prefix = _prefix(cfg, prefix_embeds)
    h = _embed_tokens(model, cfg, tokens, prefix_embeds)
    positions = torch.arange(h.shape[1], device=h.device)[None, :]
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    for layer in all_layers(model):
        h, a = run_layer(_layer_train, remat, layer, cfg, h, positions,
                         prefix)
        aux = aux + a
    return _readout(model, cfg, h), aux


def masked_ce(logits: torch.Tensor, labels: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean cross-entropy over f32 logits (..., V) of ``labels`` (...),
    a negative label (-100) ignored: (loss, ntok), ntok the count of
    labelled positions, at least 1. Every family's loss, as each of the
    reference's four losses computes it."""
    labels = labels.long()
    logits = logits.float()
    mask = (labels >= 0).float()
    safe = torch.clamp(labels, min=0)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.take_along_dim(logits, safe[..., None], dim=-1)[..., 0]
    ce = (logz - gold) * mask
    ntok = torch.clamp(mask.sum(), min=1.0)
    return ce.sum() / ntok, ntok


def lm_loss(model: LM, cfg: ModelConfig, batch: Dict[str, torch.Tensor], *,
            aux_weight: float = 0.01
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token CE over f32 logits (:func:`masked_ce`). batch: tokens
    (B, S), labels (B, S) with -100 (any negative) = ignore, and for a
    vlm ``prefix_embeds`` (B, P, D), whose P positions' logits are
    dropped. Returns (loss + aux_weight * aux, {"loss", "aux",
    "ntok"})."""
    logits, aux = lm_forward(model, cfg, batch["tokens"],
                             prefix_embeds=batch.get("prefix_embeds"))
    if cfg.n_prefix_tokens and "prefix_embeds" in batch:
        logits = logits[:, cfg.n_prefix_tokens:]
    loss, ntok = masked_ce(logits, batch["labels"])
    total = loss + aux_weight * aux
    return total, {"loss": loss, "aux": aux, "ntok": ntok}


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *, device=None
               ) -> Dict[str, Any]:
    """Per-layer decode cache, one dict a layer in execution order
    (prefix layers first): K/V (int8 + bf16 scales with
    ``kv_cache_bits=8``), a ring of the window's width under SWA; under
    MLA the latents ``c_kv`` (B, max_len, kv_lora) and the rope keys
    ``k_rope`` (B, max_len, qk_rope) in ``cfg.dtype``."""
    _check_family(cfg)
    dh = cfg.resolved_head_dim
    eff = min(max_len, cfg.window) if cfg.window else max_len
    kv_dt = torch.int8 if cfg.kv_cache_bits == 8 else cfg.dtype
    shape = (batch, eff, cfg.n_kv_heads, dh)

    def one():
        if cfg.use_mla:
            return {key: torch.zeros((batch, max_len, width),
                                     dtype=cfg.dtype, device=device)
                    for key, width in (("c_kv", cfg.kv_lora),
                                       ("k_rope", cfg.qk_rope))}
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


def lm_prefill(model: LM, cfg: ModelConfig, tokens, *, prefix_embeds=None,
               lengths=None):
    """Run the full prompt, return (last_logits (B, 1, V), cache).

    ``lengths``: per-stream real prompt lengths for right-padded
    batches; logits come from each stream's last real position and
    ``cache["len"]`` records them. A MoE prompt routes every position of
    the batch, padding included: callers prefill MoE prompts at their
    exact length (the engine groups by length). ``prefix_embeds`` (B,
    P, D): a vlm's image prefix before the text; ``lengths`` still count
    text tokens, the logits are read at P + length - 1 and ``len`` is
    P + length (a text-only call occupies no prefix slot).
    """
    _check_family(cfg)
    prefix = _prefix(cfg, prefix_embeds)
    h = _embed_tokens(model, cfg, tokens, prefix_embeds)
    B, S, _ = h.shape
    positions = torch.arange(S, device=h.device)[None, :]
    if lengths is None:
        cache_len = torch.full((B,), S, dtype=torch.int32, device=h.device)
    else:
        cache_len = (torch.as_tensor(lengths, device=h.device).to(torch.int32)
                     + (prefix or 0))
    caches = []
    for layer in all_layers(model):
        h, c, _ = layer_forward(layer, cfg, h, positions, prefix=prefix)
        caches.append(c)
    h_last = (h[:, -1:] if lengths is None
              else last_real_slice(h, lengths, offset=prefix or 0))
    return _readout(model, cfg, h_last), {"len": cache_len, "layers": caches}


# ---------------------------------------------------------------------------
# decode: one token a slot, or a speculative verify window of W tokens
# ---------------------------------------------------------------------------
#
# A decode step is a window of one token. The verify pass of
# self-speculative decoding (runtime/speculative.py) runs W = k + 1
# tokens a slot through ONE forward, so the target's weights stream once
# a round instead of once a token, and each of its rows must get the
# bits that W chained one-token steps give it:
#   * the products batch over the window's B * W rows, in products of at
#     most ``ROW_STABLE_M`` rows, each of which gives every row the bits
#     of the B-row step's product (``kernels/build.plan_splits``; the
#     plain version pads a 1-row product); where B alone is wider, one
#     position at a time, which is the step's own product;
#   * the norms run per position, on the step's (B, 1, D) shape: on the
#     card a reduction's thread layout follows the number of rows, and
#     with it the order of the sum;
#   * the attention runs per position: scatter position i's K/V entry
#     (int8 with per-entry scales where the cache is int8), then the
#     decode attention at that position's length.
# Elementwise ops (RoPE, SiLU, the residual adds) do not depend on the
# shape. At W = 1 each per-position join is its one part, so a step
# makes no copies for the window.


def _join(parts):
    """Per-position parts joined on the window axis (one part as is)."""
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)


def _norm_rows(p, h):
    """RMSNorm of h (B, W, D), one window position at a time."""
    return _join([rmsnorm_apply(p, h[:, i:i + 1].contiguous())
                  for i in range(h.shape[1])])


def _positions(cache_len, B: int, W: int, device):
    """(B, W) positions n .. n + W - 1 of each row (n = cache_len)."""
    base = torch.as_tensor(cache_len, device=device).reshape(-1).expand(B)
    base = base.reshape(B, 1)
    if W == 1:
        return base
    return base + torch.arange(W, dtype=base.dtype, device=device)[None, :]


def attn_decode(p: Attention, cfg: ModelConfig, x, cache, pos):
    """Decode attention of W tokens a slot against this layer's cache.
    x: (B, W, D); pos: (B, W) their positions.

    With SWA the cache is a ring of width ``window`` (slot = position %
    width). With ``kv_cache_bits=8`` it holds int8 K/V plus per-entry
    bf16 scales. Each position's entry is written into the cache tensors
    in place (the reference returns new arrays) just before that
    position attends; under a ring a window overwrites columns that
    ``runtime/speculative.py`` snapshots and restores.
    """
    B, W, _ = x.shape
    q, k, v = _qkv(p, cfg, x, pos, ROW_STABLE_M)
    eff = cache["k"].shape[1]
    quant = cfg.kv_cache_bits == 8
    if quant:
        k, k_s = _kv_quant(k, 8)
        v, v_s = _kv_quant(v, 8)
    ring = cfg.window is not None and eff <= cfg.window
    rows = torch.arange(B, device=x.device)
    kc, vc = cache["k"], cache["v"]
    outs = []
    for i in range(W):
        idx = pos[:, i].long()
        slot = idx % eff if ring else torch.clamp(idx, max=eff - 1)
        kc[rows, slot] = k[:, i].to(kc.dtype)
        vc[rows, slot] = v[:, i].to(vc.dtype)
        kd, vd = kc, vc
        if quant:
            ks, vs = cache["k_scale"], cache["v_scale"]
            ks[rows, slot] = k_s[:, i]
            vs[rows, slot] = v_s[:, i]
            # a bf16 product, whatever the working dtype, as the reference
            kd = kc.to(torch.bfloat16) * ks[..., None]
            vd = vc.to(torch.bfloat16) * vs[..., None]
        qi = q[:, i:i + 1].contiguous()
        if ring:  # all filled ring slots live
            outs.append(decode_attention(qi, kd, vd,
                                         torch.clamp(idx + 1, max=eff)))
        else:
            outs.append(decode_attention(qi, kd, vd, idx + 1,
                                         window=cfg.window))
    return _lin(p.o, cfg, _join(outs).reshape(B, W, -1), ROW_STABLE_M)


def lm_decode(model: LM, cfg: ModelConfig, tokens, cache):
    """tokens: (B, W) -> (logits (B, W, V), cache with len + W). A MoE
    layer routes the B tokens of a step at the decode capacity factor;
    a verify window (W > 1) serves dense configs only, as in the
    reference (MoE routing would couple the window's tokens; MLA decodes
    one token a step)."""
    _check_family(cfg)
    B, W = tokens.shape
    if W > 1 and (cfg.n_experts or cfg.use_mla):
        raise ValueError("a decode window (W > 1) serves dense configs "
                         "only: MoE routing couples the window's tokens, "
                         "and MLA decodes one token a step")
    h = _embed_tokens(model, cfg, tokens)
    pos = _positions(cache["len"], B, W, h.device)
    for layer, c in zip(all_layers(model), cache["layers"]):
        x = _norm_rows(layer.ln1, h)
        if cfg.use_mla:
            h = h + mla_decode(layer.attn, x, c, pos, **_mla_dims(cfg),
                               backend=cfg.kernel_backend,
                               act_bits=cfg.act_bits)
        else:
            h = h + attn_decode(layer.attn, cfg, x, c, pos)
        h = h + ffn_apply(layer, cfg, _norm_rows(layer.ln2, h),
                          ROW_STABLE_M, decode=True)[0]
    logits = _head(model, cfg, _norm_rows(model.final_norm, h), ROW_STABLE_M)
    return logits, {"layers": cache["layers"], "len": cache["len"] + W}


# ---------------------------------------------------------------------------
# paged serving (block-table KV; see runtime/paged_kv.py)
# ---------------------------------------------------------------------------
#
# The paged layout replaces per-slot (B, max_len, ...) caches with a
# global page pool (P, page, Hkv, dh) per layer plus an int32 block
# table (B, NB). Decode scatters the new K/V entry through the block
# table and attends through it with ``ops.paged_attention`` (the CUDA
# kernel on the card). Chunked prefill never attends quantized pages:
# chunks write fp K/V into a transient workspace of one request and
# attend it via ``flash_attention(..., q_offset=start)``; int8
# quantization happens once, in ``lm_paged_splice``, where the slot
# path's ``adapt_prefill_cache`` quantizes. The pool, workspace and
# block table are updated in place (the reference returns new arrays).


def _paged_quant(cfg: ModelConfig) -> bool:
    return cfg.kv_cache_bits == 8


def init_paged_cache(cfg: ModelConfig, batch: int, n_pages: int,
                     page_size: int, n_blocks: int, *, device=None
                     ) -> Dict[str, Any]:
    """Paged decode cache: {"pool", "block", "len"}. ``pool`` holds one
    dict per layer: K/V (P, page, Hkv, dh) (+ (P, page, Hkv) bf16 scales
    for int8 KV). block: (B, NB) int32, all zero = every entry points at
    the trash page."""
    _check_paged(cfg)
    dh = cfg.resolved_head_dim
    quant = _paged_quant(cfg)
    kv_dt = torch.int8 if quant else cfg.dtype
    shape = (n_pages, page_size, cfg.n_kv_heads, dh)

    def one():
        c = {"k": torch.zeros(shape, dtype=kv_dt, device=device),
             "v": torch.zeros(shape, dtype=kv_dt, device=device)}
        if quant:
            for key in ("k_scale", "v_scale"):
                c[key] = torch.zeros(shape[:-1], dtype=torch.bfloat16,
                                     device=device)
        return c

    return {"pool": [one() for _ in range(cfg.n_layers)],
            "block": torch.zeros((batch, n_blocks), dtype=torch.int32,
                                 device=device),
            "len": torch.zeros((batch,), dtype=torch.int32, device=device)}


def init_paged_workspace(cfg: ModelConfig, wws: int, *, device=None):
    """fp chunk-prefill workspace of one request: per layer, K/V
    (1, wws, Hkv, dh) in the working dtype."""
    shape = (1, wws, cfg.n_kv_heads, cfg.resolved_head_dim)
    return [{"k": torch.zeros(shape, dtype=cfg.dtype, device=device),
             "v": torch.zeros(shape, dtype=cfg.dtype, device=device)}
            for _ in range(cfg.n_layers)]


def paged_attn_decode(p: Attention, cfg: ModelConfig, x, pool, block, pos):
    """Decode attention of W tokens a slot against one layer's page
    pool, the paged twin of :func:`attn_decode`: batched products, then
    per position the scatter through the block table and
    ``ops.paged_attention`` (the kernel on the card).

    Dead slots keep ``cache_len`` at 0 with an all-trash block row, so
    their scatter lands on the trash page and their output is discarded
    by the engine. The entries are written into the pool in place.
    """
    B, W, _ = x.shape
    q, k, v = _qkv(p, cfg, x, pos, ROW_STABLE_M)
    quant = _paged_quant(cfg)
    if quant:
        k, k_s = _kv_quant(k, 8)
        v, v_s = _kv_quant(v, 8)
    outs = []
    for i in range(W):
        idx = pos[:, i]
        if quant:
            scatter_token_pages(pool["k_scale"], block, idx, k_s[:, i])
            scatter_token_pages(pool["v_scale"], block, idx, v_s[:, i])
        scatter_token_pages(pool["k"], block, idx, k[:, i])
        scatter_token_pages(pool["v"], block, idx, v[:, i])
        outs.append(ops.paged_attention(
            q[:, i:i + 1].contiguous(), pool["k"], pool["v"], block, idx + 1,
            window=cfg.window, k_scale=pool.get("k_scale"),
            v_scale=pool.get("v_scale")))
    return _lin(p.o, cfg, _join(outs).reshape(B, W, -1), ROW_STABLE_M)


def lm_paged_decode(model: LM, cfg: ModelConfig, tokens, cache):
    """tokens: (B, W) -> (logits (B, W, V), cache with len + W)."""
    _check_paged(cfg)
    h = _embed_tokens(model, cfg, tokens)
    B, W = tokens.shape
    pos = _positions(cache["len"], B, W, h.device)
    for layer, pool in zip(model.layers, cache["pool"]):
        h = h + paged_attn_decode(layer.attn, cfg, _norm_rows(layer.ln1, h),
                                  pool, cache["block"], pos)
        h = h + mlp_apply(layer.mlp, cfg, _norm_rows(layer.ln2, h),
                          ROW_STABLE_M)
    logits = _head(model, cfg, _norm_rows(model.final_norm, h), ROW_STABLE_M)
    return logits, {"pool": cache["pool"], "block": cache["block"],
                    "len": cache["len"] + W}


def lm_paged_prefill_chunk(model: LM, cfg: ModelConfig, tokens, ws, start,
                           n_real):
    """One prompt chunk. tokens: (1, C); ws: the workspace, holding K/V
    of positions [0, start) (earlier chunks or a prefix-cache hydrate).

    Writes the chunk's K/V at [start, start + C) and returns (logits
    (1, 1, V) at chunk row ``n_real - 1``, ws). Rows past ``n_real`` are
    padding: their logits are not read and the splice skips them.
    ``start`` and ``n_real`` are ints or 0-dim int32 tensors on the
    workspace's device, the reference's traced scalars: with tensors
    nothing is read on the host, so one CUDA graph of a chunk width
    replays at every start. The caller keeps ``start + C`` within the
    workspace.
    """
    _check_paged(cfg)
    C = tokens.shape[1]
    h = _embed_tokens(model, cfg, tokens)
    positions = start + torch.arange(C, device=h.device)[None, :]
    for layer, w in zip(model.layers, ws):
        q, k, v = _qkv(layer.attn, cfg, rmsnorm_apply(layer.ln1, h),
                       positions)
        w["k"].index_copy_(1, positions[0], k.to(w["k"].dtype))
        w["v"].index_copy_(1, positions[0], v.to(w["v"].dtype))
        o = flash_attention(q, w["k"], w["v"], window=cfg.window,
                            q_block=cfg.attn_q_block,
                            kv_block=cfg.attn_kv_block, q_offset=start)
        h = h + linear_apply(layer.attn.o, o.reshape(1, C, -1),
                             backend=cfg.kernel_backend,
                             act_bits=cfg.act_bits)
        h = h + mlp_apply(layer.mlp, cfg, rmsnorm_apply(layer.ln2, h))
    last = torch.as_tensor(n_real, device=h.device).reshape(1) - 1
    return _readout(model, cfg, h.index_select(1, last)), ws


def lm_paged_splice(cfg: ModelConfig, pool, ws, block_row, start, length):
    """Commit workspace positions [start, length) to the page pool
    through ``block_row`` (NB,) int32; every other workspace position is
    written to the trash page (block 0), as the reference's fixed-shape
    splice does, so ``start`` and ``length`` (ints or 0-dim tensors) are
    never read on the host. Those positions write zeros: many land on
    one trash entry, and only equal values make the result independent
    of the order of the writes (dead slots average the trash page, and
    under dynamic activation scales their rows reach the live rows'
    scale). ``start`` is the prefix-cache hit length: shared hit pages
    already hold their content and are live for other slots, so they
    are never rewritten. int8 KV quantizes here, per entry, with the
    slot path's ``_kv_quant``."""
    page = pool[0]["k"].shape[1]
    dev = pool[0]["k"].device
    row = torch.as_tensor(block_row, device=dev).long()
    NB = row.shape[0]
    pos = torch.arange(ws[0]["k"].shape[1], device=dev)
    valid = (pos >= start) & (pos < length)
    phys = torch.where(valid, row[torch.clamp(pos // page, 0, NB - 1)], 0)
    off = pos % page
    quant = _paged_quant(cfg)
    live = valid[:, None, None]
    for c, w in zip(pool, ws):
        for key in ("k", "v"):
            val = torch.where(live, w[key][0], 0)
            if quant:
                val, sc = _kv_quant(val, 8)
                c[f"{key}_scale"][phys, off] = sc
            c[key][phys, off] = val.to(c[key].dtype)
    return pool


def lm_paged_hydrate(cfg: ModelConfig, pool, block_row, hist_len, ws):
    """Rebuild the workspace prefix [0, hist_len) from cached pages (a
    prefix-cache hit), zero beyond: the whole row is gathered and masked
    by ``hist_len`` (an int or a 0-dim tensor, never read on the host).
    Exact for fp pools; for int8 pools the hydrated prefix is the
    dequantized cache."""
    dev = pool[0]["k"].device
    row = torch.as_tensor(block_row, device=dev)[None]
    quant = _paged_quant(cfg)
    width = row.shape[1] * pool[0]["k"].shape[1]
    live = (torch.arange(width, device=dev) < hist_len)[:, None, None]
    for c, w in zip(pool, ws):
        for key in ("k", "v"):
            val = gather_pages(c[key], row)[0]
            if quant:
                sc = gather_pages(c[f"{key}_scale"], row)[0]
                val = val.to(torch.bfloat16) * sc[..., None]
            w[key][0, :width] = torch.where(live, val.to(w[key].dtype), 0)
            w[key][0, width:].zero_()
    return ws


def lm_paged_prefill_packed(model: LM, cfg: ModelConfig, tokens, pool,
                            blocks, bases, hists, lens, wws: int):
    """Packed prefill: several prompts' tails in ONE chunk call.

    tokens: (1, C), the segments' tail tokens back to back (rows past
    their sum are padding, masked everywhere). blocks: (S, NB) block
    rows; bases: (S,) each segment's workspace base, aligned to
    ``cfg.attn_kv_block`` and non-decreasing (inactive segments park at
    the total span); hists / lens: (S,) prefix-hit and prompt lengths (0
    for an inactive segment). blocks, bases, hists and lens are integer
    tensors (or arrays) and nothing is read on the host, so one CUDA
    graph of a width replays for every group.

    Does per layer what the unpacked path does in a hydrate, a chunk and
    a splice: a ``wws``-position workspace holds each segment's prefix
    [0, hist) from the pool (dequantized where the pool is int8) and its
    tail's fresh K/V at ``base + position``, zeros elsewhere; the chunk
    attends it with per-token positions and segments
    (``flash_attention``'s overrides); then positions [hist, len) of
    each segment go to its pages and every other workspace position
    writes zeros to the trash page (see ``lm_paged_splice``). The pool
    is updated in place. Returns logits (S, 1, V), row s read at segment
    s's last tail row (an inactive segment's row is not meaningful).

    A segment's rows get the bits of its own unpacked hydrate + chunk +
    splice where every op's rows are independent of the call's width:
    masked kv blocks leave the online softmax as it was, and the bases'
    alignment puts a segment's entries in the kv blocks, at the
    in-block offsets, that an unpacked chunk puts them. The readout
    norms each segment's row on its own, as the chunk norms its one row.
    """
    _check_paged(cfg)
    C = tokens.shape[1]
    dev = pool[0]["k"].device
    page = pool[0]["k"].shape[1]

    def ints(t):
        return torch.as_tensor(t, device=dev).long()

    blocks, bases, hists, lens = map(ints, (blocks, bases, hists, lens))
    S, NB = blocks.shape
    # packed-q geometry: row i belongs to segment q_seg[i] at in-prompt
    # position q_pos[i] = hist + its offset within the tail
    tails = lens - hists
    ends = torch.cumsum(tails, 0)
    firsts = ends - tails
    qi = torch.arange(C, device=dev)
    q_valid = qi < ends[S - 1]
    q_seg = torch.clamp(torch.searchsorted(ends, qi, right=True), 0, S - 1)
    q_pos = torch.where(q_valid, hists[q_seg] + qi - firsts[q_seg], -1)
    q_seg_m = torch.where(q_valid, q_seg, -2)  # matches no key
    positions = torch.clamp(q_pos, min=0)[None, :]
    # workspace geometry: position w belongs to the last segment whose
    # base is <= w, at in-prompt position w_local
    wpos = torch.arange(wws, device=dev)
    w_seg = torch.clamp(torch.searchsorted(bases, wpos, right=True) - 1, 0,
                        S - 1)
    w_local = wpos - bases[w_seg]
    w_blk = blocks[w_seg, torch.clamp(w_local // page, 0, NB - 1)]
    gather_idx = w_blk * page + w_local % page
    hyd_live = (w_local < hists[w_seg])[:, None, None]
    spl_valid = (w_local >= hists[w_seg]) & (w_local < lens[w_seg])
    # the chunk row whose K/V lands at w (the tail rows, back to back)
    w_row = torch.clamp(firsts[w_seg] + w_local - hists[w_seg], 0, C - 1)
    spl_live = spl_valid[:, None, None]
    spl_idx = torch.where(spl_valid, w_blk, 0) * page + w_local % page
    quant = _paged_quant(cfg)

    def flat(t):
        return t.reshape((-1,) + tuple(t.shape[2:]))

    h = _embed_tokens(model, cfg, tokens)
    for layer, c in zip(model.layers, pool):
        q, k, v = _qkv(layer.attn, cfg, rmsnorm_apply(layer.ln1, h),
                       positions)
        ws = {}
        for key, fresh in (("k", k), ("v", v)):
            # the hydrate of lm_paged_hydrate, position by position
            val = flat(c[key])[gather_idx]
            if quant:
                val = val.to(torch.bfloat16) * flat(
                    c[f"{key}_scale"])[gather_idx][..., None]
            val = torch.where(hyd_live, val.to(cfg.dtype), 0)
            ws[key] = torch.where(spl_live, fresh[0][w_row].to(cfg.dtype),
                                  val)
        o = flash_attention(q, ws["k"][None], ws["v"][None],
                            window=cfg.window, q_block=cfg.attn_q_block,
                            kv_block=cfg.attn_kv_block,
                            q_positions=q_pos, kv_positions=w_local,
                            q_segments=q_seg_m, kv_segments=w_seg)
        h = h + linear_apply(layer.attn.o, o.reshape(1, C, -1),
                             backend=cfg.kernel_backend,
                             act_bits=cfg.act_bits)
        h = h + mlp_apply(layer.mlp, cfg, rmsnorm_apply(layer.ln2, h))
        # the splice: [hist, len) of each segment to its pages, zeros to
        # the trash page from every other position
        for key in ("k", "v"):
            val = torch.where(spl_live, ws[key], 0)
            if quant:
                val, sc = _kv_quant(val, 8)
                flat(c[f"{key}_scale"])[spl_idx] = sc
            flat(c[key])[spl_idx] = val.to(c[key].dtype)
    last = torch.clamp(ends - 1, 0, C - 1)
    # each segment's row normed on its own, as the chunk's readout norms
    # its one row, then one head product over the S rows (at most
    # ROW_STABLE_M rows give each row a one-row product's bits)
    normed = torch.cat([rmsnorm_apply(model.final_norm, h[:, last[s:s + 1]])
                        for s in range(S)])
    return _head(model, cfg, normed, ROW_STABLE_M)
