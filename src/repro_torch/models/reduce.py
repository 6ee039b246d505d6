"""Reduced configs: same family/features, tiny dims, for CPU tests
(counterpart of ``repro.models.reduce``)."""
from __future__ import annotations

import torch

from repro_torch.models.config import ModelConfig


def reduced(cfg: ModelConfig, *, seq_friendly: bool = True) -> ModelConfig:
    """Shrink a config to CPU scale while preserving every structural
    feature (GQA ratio, SWA, MLA, MoE routing, shared blocks, enc-dec...)."""
    kw = dict(
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=max(1, min(cfg.n_kv_heads * 4 // max(cfg.n_heads, 1), 4)) or 1,
        d_ff=96,
        vocab=211,
        head_dim=16,
        dtype=torch.float32,
        attn_q_block=16,
        attn_kv_block=16,
        ssm_chunk=8,
        remat=cfg.remat,
    )
    if cfg.window is not None:
        kw["window"] = 24
    if cfg.n_experts:
        kw.update(n_experts=4, top_k=min(cfg.top_k, 2), capacity_factor=4.0)
        if cfg.n_shared_experts:
            kw.update(n_shared_experts=1, d_ff_shared=96)
        if cfg.first_dense:
            kw.update(first_dense=1, n_layers=3)
    if cfg.use_mla:
        kw.update(kv_lora=24, qk_nope=16, qk_rope=8, v_head=16)
    if cfg.family == "hybrid":
        kw.update(n_layers=4, attn_every=2, d_inner=128, ssm_state=16,
                  ssm_head_dim=16, n_kv_heads=4)
    if cfg.family == "ssm":
        kw.update(ssm_head_dim=16, d_ff=128)
    if cfg.family == "encdec":
        kw.update(enc_layers=2)
    if cfg.family == "vlm":
        kw.update(n_prefix_tokens=8)
    return cfg.replace(**kw)
