"""Model API (counterpart of ``repro.models.api``), dense family.

    init(cfg, seed=, device=)                  -> model
    quantize(model, cfg)                       -> model (in place)
    loss_fn(model, cfg, batch)                 -> (loss, metrics)
    serve_state(cfg, seed=, pack4=, device=)   -> serve model [, manifest]
    prefill(model, cfg, batch, lengths=)       -> (logits, cache)
    decode_step(model, cfg, token, cache)      -> (logits, cache)
    init_cache(cfg, batch, max_len, device=)   -> cache

Every entry point that creates tensors runs on ``device="cuda"`` unless
the caller passes ``device="cpu"``; asking for CUDA where there is none
raises.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.core.policy import quantize_tree
from repro_torch.device import resolve_device
from repro_torch.models import lm as m_lm
from repro_torch.models.config import ModelConfig


def _dense_only(cfg: ModelConfig):
    if cfg.family != "dense":
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (ROADMAP queue 1 "
            f"item 6); the port serves the dense family")


def init(cfg: ModelConfig, *, seed: int = 0, device="cuda") -> nn.Module:
    """Random fp32 model from ``seed``, built on ``device``."""
    _dense_only(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return m_lm.init_lm(gen, cfg, device=dev)


def resolved_policy(cfg: ModelConfig):
    """The effective QuantPolicy for a config (None = fp baseline)."""
    from repro_torch.core.rules import EMBED_PATTERN, QuantRule, as_policy

    policy = as_policy(cfg.quant)
    if policy is None:
        return None
    if not cfg.quantize_embed:
        policy = policy.prepend(QuantRule(EMBED_PATTERN, None, name="embed-fp"))
    return policy


def quantize(model: nn.Module, cfg: ModelConfig) -> nn.Module:
    """Install LUT-Q state on every eligible kernel (paper step 0), in
    place."""
    policy = resolved_policy(cfg)
    if policy is None:
        return model
    return quantize_tree(model, policy)


def serve_state(cfg: ModelConfig, *, seed: int = 0, pack4: bool = False,
                with_manifest: bool = False, device="cuda"):
    """init -> quantize -> serve_view. Returns the serve model (plus the
    backend manifest with ``with_manifest=True``); the fp masters are
    dropped with the quantized tree."""
    from repro_torch.core.policy import serve_view

    qmodel = quantize(init(cfg, seed=seed, device=device), cfg)
    return serve_view(qmodel, pack4=pack4, policy=resolved_policy(cfg),
                      with_manifest=with_manifest)


def loss_fn(model: nn.Module, cfg: ModelConfig, batch):
    """Training loss of a batch (tokens, labels): (loss, metrics)."""
    _dense_only(cfg)
    return m_lm.lm_loss(model, cfg, batch)


def prefill(model: nn.Module, cfg: ModelConfig, batch, *, lengths=None):
    """Run the prompt, return (last_logits (B, 1, V), cache)."""
    _dense_only(cfg)
    return m_lm.lm_prefill(model, cfg, batch["tokens"], lengths=lengths)


def decode_step(model: nn.Module, cfg: ModelConfig, token, cache):
    _dense_only(cfg)
    return m_lm.lm_decode_step(model, cfg, token, cache)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               device="cuda"):
    _dense_only(cfg)
    return m_lm.init_cache(cfg, batch, max_len, device=resolve_device(device))
