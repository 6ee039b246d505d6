"""Architecture registry (counterpart of ``repro.configs``).

The port registers the configurations it can serve: the dense
``h2o-danube-1.8b`` so far.
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
    from repro_torch.configs import h2o_danube_1_8b  # noqa: F401
