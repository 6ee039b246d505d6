"""Zamba2-style hybrid: a Mamba2 backbone and one *shared* attention
block.

Counterpart of ``repro.models.zamba``. The model is ``n_super =
n_layers // attn_every`` super-blocks, each ``attn_every`` Mamba2 layers
followed by one application of a single shared transformer block
(``models/lm.py``'s attention and MLP, parameters reused by every
application, as Zamba shares them). The reference stacks the Mamba
parameters (n_super, attn_every, ...) and scans over both axes; here
they are an ``nn.ModuleList`` of ``nn.ModuleList``s walked by a Python
loop (``mamba_layers.<s>.<i>``, which ``nn/tree.py`` maps back to the
stacked path ``mamba_layers/mamba/in_proj/kernel``). The shared block
(``shared.attn.q.kernel``, ``shared.mlp.wi.kernel``, ``shared.ln1``,
``shared.ln2``) is one module with one set of dictionaries.

Slot cache, one dict an entry in execution order:
``{"layers": [...], "len"}``, where a Mamba layer's entry is ``{"ssm":
(B, H, N, P) f32, "conv": (B, 3, conv_dim) cfg.dtype}`` and each
application of the shared block has ``{"k", "v": (B, max_len, Hkv,
dh)}`` in ``cfg.dtype``. A decode step writes every entry in place: the
new K/V column, and the SSM state and conv window whole, so the slot
engine's captured step replays on its own buffers. The family keeps
16-bit K/V and no window, as the reference's cache; it pages nothing,
speculates nothing and decodes one token a step (its recurrent state
cannot rewind), and its prompts are prefilled at their exact length,
since the state integrates padding.

Training (``zamba_loss``) runs the whole sequence through every layer
to the tied readout's logits and the masked CE of ``models/lm.py``; with
``cfg.remat`` each Mamba layer is recomputed in the backward, and the
SSD scan inside it keeps one chunk's decay at a time.

Entry points:
  init_zamba         random model from a generator
  zamba_forward      (B, S) tokens -> logits (training forward)
  zamba_loss         the training loss of a batch
  zamba_prefill      (B, S) prompt -> last logits + slot cache
  init_zamba_cache   an empty slot cache
  zamba_decode       (B, 1) tokens -> logits + the cache, updated in place
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch import nn

from repro_torch.models.config import ModelConfig
from repro_torch.models.lm import (Layer, _embed_tokens, _head, _positions,
                                   attn_decode, attn_forward, attn_init,
                                   last_real_slice, masked_ce, mlp_apply,
                                   mlp_init, remat_layers, run_layer)
from repro_torch.nn.linear import embedding_init
from repro_torch.nn.mamba2 import (CONV_K, Mamba2, mamba2_decode,
                                   mamba2_forward, mamba2_init)
from repro_torch.nn.norms import rmsnorm_apply, rmsnorm_init


class MambaLayer(nn.Module):
    def __init__(self, ln, mamba: Mamba2):
        super().__init__()
        self.ln, self.mamba = ln, mamba


class Zamba(nn.Module):
    """State-dict keys follow the reference's pytree paths:
    ``embed.table``, ``mamba_layers.<s>.<i>.ln.scale``,
    ``mamba_layers.<s>.<i>.mamba.in_proj.kernel``,
    ``shared.attn.q.kernel``, ``shared.mlp.wo.kernel``,
    ``final_norm.scale``."""

    def __init__(self, embed, mamba_layers, shared: Layer, final_norm):
        super().__init__()
        self.embed = embed
        self.mamba_layers = nn.ModuleList(nn.ModuleList(row)
                                          for row in mamba_layers)
        self.shared = shared
        self.final_norm = final_norm


def _check(cfg: ModelConfig):
    if cfg.family != "hybrid":
        raise ValueError(f"models/zamba serves the hybrid family, not "
                         f"{cfg.family!r} (config {cfg.name!r})")
    if cfg.n_layers % cfg.attn_every:
        raise ValueError(f"n_layers {cfg.n_layers} is not a multiple of "
                         f"attn_every {cfg.attn_every}")
    if cfg.kv_cache_bits == 8:
        raise ValueError("kv_cache_bits=8 is not served for the hybrid "
                         "family: its shared block's cache holds 16-bit "
                         "K/V, as the reference's")
    if cfg.window is not None:
        raise ValueError("the hybrid family's shared attention has no "
                         "window")


def n_super(cfg: ModelConfig) -> int:
    """Super-blocks (applications of the shared block)."""
    return cfg.n_layers // cfg.attn_every


def _dims(cfg: ModelConfig) -> Dict[str, int]:
    return dict(d_inner=cfg.resolved_d_inner, n_state=cfg.ssm_state,
                head_dim=cfg.ssm_head_dim)


def _kw(cfg: ModelConfig) -> Dict[str, Any]:
    return dict(_dims(cfg), backend=cfg.kernel_backend, act_bits=cfg.act_bits)


def init_zamba(gen: Optional[torch.Generator], cfg: ModelConfig,
               device=None) -> Zamba:
    """Random fp32 parameters from ``gen`` (None: unseeded, e.g. on the
    meta device as a skeleton to load weights into)."""
    _check(cfg)
    embed = embedding_init(gen, cfg.vocab, cfg.d_model, device=device)
    rows = [[MambaLayer(rmsnorm_init(cfg.d_model, device=device),
                        mamba2_init(gen, cfg.d_model, **_dims(cfg),
                                    device=device))
             for _ in range(cfg.attn_every)]
            for _ in range(n_super(cfg))]
    shared = Layer(rmsnorm_init(cfg.d_model, device=device),
                   rmsnorm_init(cfg.d_model, device=device),
                   attn_init(gen, cfg, device=device),
                   mlp=mlp_init(gen, cfg, device=device))
    return Zamba(embed, rows, shared,
                 rmsnorm_init(cfg.d_model, device=device))


def _shared_block(model: Zamba, cfg: ModelConfig, h, positions):
    sp = model.shared
    a, cache = attn_forward(sp.attn, cfg, rmsnorm_apply(sp.ln1, h), positions)
    h = h + a
    h = h + mlp_apply(sp.mlp, cfg, rmsnorm_apply(sp.ln2, h))
    return h, cache


def _mamba_layer(layer: MambaLayer, cfg: ModelConfig, h):
    """h + the layer's Mamba2 block over the whole sequence: (h, its
    {"ssm", "conv"} state after the last position)."""
    out, st = mamba2_forward(layer.mamba, rmsnorm_apply(layer.ln, h),
                             chunk=cfg.ssm_chunk, **_kw(cfg))
    return h + out, st


def _mamba_layer_train(layer: MambaLayer, cfg: ModelConfig, h):
    return _mamba_layer(layer, cfg, h)[0]


def zamba_forward(model: Zamba, cfg: ModelConfig, tokens) -> torch.Tensor:
    """The training forward: (B, S) tokens -> logits (B, S, V) of the
    tied readout. After each super-block's Mamba layers the shared block
    runs over its own K/V of the whole sequence. With ``cfg.remat``
    each Mamba layer is recomputed in the backward
    (``torch.utils.checkpoint``), as the reference's ``remat_wrap`` of
    its inner scan body (the shared block is not); inside a layer the
    SSD scan keeps only its chunk-boundary states in any case
    (``nn/mamba2.ssd_chunked``)."""
    _check(cfg)
    remat = remat_layers(cfg)
    h = _embed_tokens(model, cfg, tokens)
    positions = torch.arange(h.shape[1], device=h.device)[None, :]
    for row in model.mamba_layers:
        for layer in row:
            h = run_layer(_mamba_layer_train, remat, layer, cfg, h)
        h, _ = _shared_block(model, cfg, h, positions)
    return _head(model, cfg, rmsnorm_apply(model.final_norm, h))


def zamba_loss(model: Zamba, cfg: ModelConfig, batch):
    """batch: tokens (B, S), labels (B, S) (-100 = ignore) -> (loss,
    {"loss"}): the masked CE over f32 logits (``lm.masked_ce``), as the
    reference's ``zamba_loss``."""
    loss, _ = masked_ce(zamba_forward(model, cfg, batch["tokens"]),
                        batch["labels"])
    return loss, {"loss": loss}


def zamba_prefill(model: Zamba, cfg: ModelConfig, tokens, *, lengths=None):
    """Run the prompt, return (last_logits (B, 1, V), slot cache).

    ``lengths``: per-stream real prompt lengths; logits are read at
    each stream's last real token and ``len`` records them, but the
    Mamba state still integrates the right-padding, so callers prefill
    ragged prompts one length at a time (``runtime/engine.py`` groups
    them by exact length, ``generate`` submits each padded stream
    alone). The shared block's K/V are the prompt's S columns;
    ``serving.adapt_prefill_cache`` grows them to the engine's width.
    """
    _check(cfg)
    h = _embed_tokens(model, cfg, tokens)
    B, S, _ = h.shape
    positions = torch.arange(S, device=h.device)[None, :]
    layers = []
    for row in model.mamba_layers:
        for layer in row:
            h, st = _mamba_layer(layer, cfg, h)
            layers.append(st)
        h, c = _shared_block(model, cfg, h, positions)
        layers.append(c)
    h_last = h[:, -1:] if lengths is None else last_real_slice(h, lengths)
    logits = _head(model, cfg, rmsnorm_apply(model.final_norm, h_last))
    cache_len = (torch.full((B,), S, dtype=torch.int32, device=h.device)
                 if lengths is None else
                 torch.as_tensor(lengths, device=h.device).to(torch.int32))
    return logits, {"layers": layers, "len": cache_len}


def init_zamba_cache(cfg: ModelConfig, batch: int, max_len: int, *,
                     device=None) -> Dict[str, Any]:
    """An empty slot cache (zero state, zero K/V, len 0)."""
    _check(cfg)
    H = cfg.resolved_d_inner // cfg.ssm_head_dim
    conv_dim = cfg.resolved_d_inner + 2 * cfg.ssm_state
    kv = (batch, max_len, cfg.n_kv_heads, cfg.resolved_head_dim)
    layers = []
    for _ in range(n_super(cfg)):
        layers += [{"ssm": torch.zeros((batch, H, cfg.ssm_state,
                                        cfg.ssm_head_dim),
                                       dtype=torch.float32, device=device),
                    "conv": torch.zeros((batch, CONV_K - 1, conv_dim),
                                        dtype=cfg.dtype, device=device)}
                   for _ in range(cfg.attn_every)]
        layers.append({key: torch.zeros(kv, dtype=cfg.dtype, device=device)
                       for key in ("k", "v")})
    return {"layers": layers,
            "len": torch.zeros((batch,), dtype=torch.int32, device=device)}


def zamba_decode(model: Zamba, cfg: ModelConfig, tokens, cache):
    """tokens (B, 1) -> (logits (B, 1, V), cache with len + 1). Every
    state entry of ``cache`` is written in place."""
    _check(cfg)
    B, W = tokens.shape
    if W != 1:
        raise ValueError("a decode window (W > 1) is not served for the "
                         "hybrid family: its recurrent state advances one "
                         "token a step and cannot rewind")
    h = _embed_tokens(model, cfg, tokens)
    pos = _positions(cache["len"], B, 1, h.device)
    sp = model.shared
    entries = iter(cache["layers"])
    for row in model.mamba_layers:
        for layer in row:
            h = h + mamba2_decode(layer.mamba, rmsnorm_apply(layer.ln, h),
                                  next(entries), **_kw(cfg))
        h = h + attn_decode(sp.attn, cfg, rmsnorm_apply(sp.ln1, h),
                            next(entries), pos)
        h = h + mlp_apply(sp.mlp, cfg, rmsnorm_apply(sp.ln2, h))
    logits = _head(model, cfg, rmsnorm_apply(model.final_norm, h))
    return logits, {"layers": cache["layers"], "len": cache["len"] + 1}
