"""Unified architecture config (counterpart of ``repro.models.config``).

The port serves the ``dense`` family only so far; the other families' fields
are kept so configs and policies read the same in both packages.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Union

import torch

from repro_torch.core.rules import QuantPolicy
from repro_torch.core.spec import QuantSpec


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | vlm | encdec | hybrid | ssm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int

    head_dim: Optional[int] = None
    qkv_bias: bool = False
    use_qk_norm: bool = False
    window: Optional[int] = None          # sliding-window attention width
    rope_theta: float = 10000.0
    tie_embeddings: bool = True

    # MoE
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    d_ff_shared: Optional[int] = None
    first_dense: int = 0                  # leading dense-FFN layers (deepseek)
    capacity_factor: float = 1.25

    # MLA (deepseek)
    use_mla: bool = False
    kv_lora: int = 512
    qk_nope: int = 128
    qk_rope: int = 64
    v_head: int = 128

    # SSM / hybrid
    ssm_state: int = 64
    ssm_head_dim: int = 64
    d_inner: Optional[int] = None
    attn_every: int = 6                   # zamba2: shared attn period

    # enc-dec
    enc_layers: int = 0

    # modality stub (vlm/audio): prepended precomputed embeddings
    n_prefix_tokens: int = 0

    # compute
    dtype: Any = torch.bfloat16
    scan_layers: bool = True
    remat: bool = True
    remat_policy: str = "full"  # full | dots (save matmul outputs) | none
    attn_q_block: int = 512
    attn_kv_block: int = 512
    ssm_chunk: int = 128

    # serving optimizations
    kv_cache_bits: int = 16     # 8 = int8 KV cache with per-step scales
    pack_assignments: bool = False  # two 4-bit LUT indices per byte (K<=16)
    # kernel execution backend for quantized matmuls (kernels/ops.lutq_dot):
    # "auto" resolves per leaf (train/STE -> decode, serve int8 -> fused,
    # serve packed -> packed4); "decode"/"fused"/"packed4" force one path
    # model-wide (infeasible leaves degrade down the same ladder).
    kernel_backend: str = "auto"

    # quantization (the paper's technique; None = fp baseline).
    # A bare QuantSpec means "uniform policy" (auto-wrapped); a
    # QuantPolicy gives rule-based mixed precision (see core/rules.py).
    quant: Optional[Union[QuantSpec, QuantPolicy]] = None
    act_bits: int = 32
    quantize_embed: bool = True

    # sub-quadratic? (drives long_500k applicability)
    @property
    def subquadratic(self) -> bool:
        return self.family in ("hybrid", "ssm") or self.window is not None

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def resolved_d_inner(self) -> int:
        return self.d_inner or 2 * self.d_model

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)
