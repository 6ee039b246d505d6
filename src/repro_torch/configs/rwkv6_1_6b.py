"""rwkv6-1.6b (Finch) [ssm]: attention-free, data-dependent decay.

24L d_model=2048 d_ff=7168 vocab=65536 [arXiv:2404.05892; unverified]
"""
from repro_torch.configs import register
from repro_torch.core.spec import LUTQ_4BIT_POW2
from repro_torch.models.config import ModelConfig

CONFIG = register(ModelConfig(
    name="rwkv6-1.6b",
    family="ssm",
    n_layers=24,
    d_model=2048,
    n_heads=32,            # wkv heads = d_model / ssm_head_dim
    n_kv_heads=32,
    d_ff=7168,
    vocab=65536,
    ssm_head_dim=64,
    tie_embeddings=True,
    quant=LUTQ_4BIT_POW2,
    act_bits=8,
))
