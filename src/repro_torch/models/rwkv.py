"""RWKV6 language model: attention-free, a fixed-size decode state.

Counterpart of ``repro.models.rwkv``. ``n_layers`` pre-norm RWKV6 layers
(``nn/rwkv6.py``: time-mix, then channel-mix), a tied readout. The
reference stacks the layers' parameters and scans them; here they are an
``nn.ModuleList`` (``layers.<i>.mix.w1``, which ``nn/tree.py`` maps back
to the stacked path ``layers/mix/w1``).

The residual stream is f32 whatever ``cfg.dtype`` is, as the
reference's: the embedding is gathered in ``cfg.dtype`` and cast to
f32, every product of the body takes f32 activations, and the stream
returns to ``cfg.dtype`` only before the final norm. The readout is
``embedding_logits`` at the config's backend and no activation
quantization, as the reference's.

Slot cache: ``{"layers": [...], "len"}``, one dict a layer, ``{"shift_t",
"shift_c": (B, 1, D) f32, "wkv": (B, H, dk, dv) f32}``. A decode step
writes every entry in place, so the slot engine's captured step replays
on its own buffers. The state integrates every position it is given, so
prompts are prefilled at their exact length; the family pages nothing,
speculates nothing and decodes one token a step (its state cannot
rewind).

Training (``rwkv_loss``) runs the whole sequence from a zero state to
the tied readout's logits and the masked CE of ``models/lm.py``; with
``cfg.remat`` each layer is recomputed in the backward, and the WKV scan
inside it is checkpointed a chunk of ``cfg.ssm_chunk`` tokens at a time.

Entry points:
  init_rwkv         random model from a generator
  rwkv_forward      (B, S) tokens -> logits (training forward)
  rwkv_loss         the training loss of a batch
  rwkv_prefill      (B, S) prompt -> last logits + slot cache
  init_rwkv_cache   an empty slot cache
  rwkv_decode       (B, 1) tokens -> logits + the cache, updated in place
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch import nn

from repro_torch.models.config import ModelConfig
from repro_torch.models.lm import last_real_slice, masked_ce, run_layer
from repro_torch.nn.linear import (embedding_apply, embedding_init,
                                   embedding_logits)
from repro_torch.nn.norms import rmsnorm_apply, rmsnorm_init
from repro_torch.nn.rwkv6 import RWKV6, rwkv6_block, rwkv6_decode, rwkv6_init


class RWKVLayer(nn.Module):
    def __init__(self, ln1, ln2, mix: RWKV6):
        super().__init__()
        self.ln1, self.ln2, self.mix = ln1, ln2, mix


class RWKV(nn.Module):
    """State-dict keys follow the reference's pytree paths:
    ``embed.table``, ``layers.<i>.ln1.scale``, ``layers.<i>.mix.r.kernel``,
    ``layers.<i>.mix.w1``, ``final_norm.scale``."""

    def __init__(self, embed, layers, final_norm):
        super().__init__()
        self.embed = embed
        self.layers = nn.ModuleList(layers)
        self.final_norm = final_norm


def _check(cfg: ModelConfig):
    if cfg.family != "ssm":
        raise ValueError(f"models/rwkv serves the ssm family, not "
                         f"{cfg.family!r} (config {cfg.name!r})")
    if cfg.d_model % cfg.ssm_head_dim:
        raise ValueError(f"d_model {cfg.d_model} is not a multiple of "
                         f"ssm_head_dim {cfg.ssm_head_dim}")


def _kw(cfg: ModelConfig) -> Dict[str, Any]:
    return dict(head_dim=cfg.ssm_head_dim, backend=cfg.kernel_backend,
                act_bits=cfg.act_bits)


def init_rwkv(gen: Optional[torch.Generator], cfg: ModelConfig,
              device=None) -> RWKV:
    """Random fp32 parameters from ``gen`` (None: unseeded, e.g. on the
    meta device as a skeleton to load weights into)."""
    _check(cfg)
    layers = [RWKVLayer(rmsnorm_init(cfg.d_model, device=device),
                        rmsnorm_init(cfg.d_model, device=device),
                        rwkv6_init(gen, cfg.d_model, d_ff=cfg.d_ff,
                                   device=device))
              for _ in range(cfg.n_layers)]
    return RWKV(embedding_init(gen, cfg.vocab, cfg.d_model, device=device),
                layers, rmsnorm_init(cfg.d_model, device=device))


def _layer(lp: RWKVLayer, cfg: ModelConfig, h, state, chunk=None):
    """(h, the layer's state after the last position) of one layer."""
    return rwkv6_block(lp.mix, lp.ln1, lp.ln2, h, state, chunk=chunk,
                       **_kw(cfg))


def _layer_train(lp: RWKVLayer, cfg: ModelConfig, h):
    return _layer(lp, cfg, h, None, chunk=cfg.ssm_chunk)[0]


def _embed(model: RWKV, cfg: ModelConfig, tokens) -> torch.Tensor:
    """The tokens' rows in ``cfg.dtype``, then the f32 residual stream."""
    return embedding_apply(model.embed, tokens, dtype=cfg.dtype).float()


def _readout(model: RWKV, cfg: ModelConfig, h) -> torch.Tensor:
    h = rmsnorm_apply(model.final_norm, h.to(cfg.dtype))
    return embedding_logits(model.embed, h, backend=cfg.kernel_backend)


def rwkv_forward(model: RWKV, cfg: ModelConfig, tokens) -> torch.Tensor:
    """The training forward: (B, S) tokens -> logits (B, S, V) of the
    tied readout, from a zero state. The f32 residual stream returns to
    ``cfg.dtype`` before the final norm, as in :func:`rwkv_prefill`.
    With ``cfg.remat`` each layer is recomputed in the backward
    (``torch.utils.checkpoint``), as the reference's ``jax.checkpoint``
    of its scan body whatever the policy; inside a layer the WKV scan
    keeps only its states every ``cfg.ssm_chunk`` tokens in any case
    (``nn/rwkv6.wkv_scan``)."""
    _check(cfg)
    remat = cfg.remat and torch.is_grad_enabled()
    h = _embed(model, cfg, tokens)
    for lp in model.layers:
        h = run_layer(_layer_train, remat, lp, cfg, h)
    return _readout(model, cfg, h)


def rwkv_loss(model: RWKV, cfg: ModelConfig, batch):
    """batch: tokens (B, S), labels (B, S) (-100 = ignore) -> (loss,
    {"loss"}): the masked CE over f32 logits (``lm.masked_ce``), as the
    reference's ``rwkv_loss``. The decay LoRA's ``w1`` / ``w2`` train
    beside the other leaves."""
    loss, _ = masked_ce(rwkv_forward(model, cfg, batch["tokens"]),
                        batch["labels"])
    return loss, {"loss": loss}


def rwkv_prefill(model: RWKV, cfg: ModelConfig, tokens, *, lengths=None):
    """Run the prompt, return (last_logits (B, 1, V), slot cache).

    ``lengths``: per-stream real prompt lengths; logits are read at each
    stream's last real token and ``len`` records them, but the state
    still integrates the right-padding (there is no position to mask
    after the fact), so callers prefill ragged prompts one length at a
    time (``runtime/engine.py`` groups them by exact length,
    ``generate`` submits each padded stream alone)."""
    _check(cfg)
    h = _embed(model, cfg, tokens)
    B, S, _ = h.shape
    layers = []
    for lp in model.layers:
        h, st = _layer(lp, cfg, h, None)
        layers.append(st)
    h_last = h[:, -1:] if lengths is None else last_real_slice(h, lengths)
    cache_len = (torch.full((B,), S, dtype=torch.int32, device=h.device)
                 if lengths is None else
                 torch.as_tensor(lengths, device=h.device).to(torch.int32))
    return _readout(model, cfg, h_last), {"layers": layers, "len": cache_len}


def init_rwkv_cache(cfg: ModelConfig, batch: int, *, device=None
                    ) -> Dict[str, Any]:
    """An empty slot cache (zero state, len 0); its size does not depend
    on a context length."""
    _check(cfg)
    H, dh = cfg.d_model // cfg.ssm_head_dim, cfg.ssm_head_dim
    f32 = dict(dtype=torch.float32, device=device)
    layers = [{"shift_t": torch.zeros((batch, 1, cfg.d_model), **f32),
               "shift_c": torch.zeros((batch, 1, cfg.d_model), **f32),
               "wkv": torch.zeros((batch, H, dh, dh), **f32)}
              for _ in range(cfg.n_layers)]
    return {"layers": layers,
            "len": torch.zeros((batch,), dtype=torch.int32, device=device)}


def rwkv_decode(model: RWKV, cfg: ModelConfig, tokens, cache):
    """tokens (B, 1) -> (logits (B, 1, V), cache with len + 1). Every
    state entry of ``cache`` is written in place."""
    _check(cfg)
    if tokens.shape[1] != 1:
        raise ValueError("a decode window (W > 1) is not served for the "
                         "ssm family: its recurrent state advances one "
                         "token a step and cannot rewind")
    h = _embed(model, cfg, tokens)
    for lp, state in zip(model.layers, cache["layers"]):
        h = rwkv6_decode(lp.mix, lp.ln1, lp.ln2, h, state, **_kw(cfg))
    return _readout(model, cfg, h), {"layers": cache["layers"],
                                     "len": cache["len"] + 1}
