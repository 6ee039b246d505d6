"""Architecture registry (counterpart of ``repro.configs``).

The port registers the configurations it can serve: the dense
``h2o-danube-1.8b``, ``mistral-nemo-12b``, ``mistral-large-123b`` (a
GQA group of 12) and ``qwen1.5-110b`` (a bias on q, k and v), the MoE
``qwen3-moe-235b-a22b`` and ``deepseek-v2-lite-16b`` (MLA with a latent
cache, one leading dense layer, shared experts), the encoder-decoder
``seamless-m4t-medium`` (cross-attention over a per-request memory, a
tied readout), the vlm ``paligemma-3b`` (a bidirectional prefix of
precomputed image embeddings before the text, MQA, a tied readout),
the hybrid ``zamba2-2.7b`` (Mamba2 layers with one shared attention
block every ``attn_every`` of them, a tied readout), and the ssm
``rwkv6-1.6b`` (RWKV6 time-mix with a data-dependent decay and
channel-mix, attention-free, a tied readout).
"""
from __future__ import annotations

from typing import Dict

from repro_torch.models.config import ModelConfig

_REGISTRY: Dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    _ensure_loaded()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_archs():
    _ensure_loaded()
    return sorted(_REGISTRY)


def _ensure_loaded():
    if _REGISTRY:
        return
    from repro_torch.configs import (  # noqa: F401
        deepseek_v2_lite_16b,
        h2o_danube_1_8b,
        mistral_large_123b,
        mistral_nemo_12b,
        paligemma_3b,
        qwen1_5_110b,
        qwen3_moe_235b_a22b,
        rwkv6_1_6b,
        seamless_m4t_medium,
        zamba2_2_7b,
    )
