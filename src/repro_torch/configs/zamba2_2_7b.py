"""zamba2-2.7b [hybrid]: Mamba2 backbone + one shared attention block.

54L d_model=2560 (mamba d_inner=5120, ssm_state=64, 80 SSM heads of 64)
+ shared attn 32H (kv=32) with d_ff=10240 MLP applied every 6 layers,
vocab=32000 tied [arXiv:2411.15242; hf]
"""
from repro_torch.configs import register
from repro_torch.core.spec import LUTQ_4BIT_POW2
from repro_torch.models.config import ModelConfig

CONFIG = register(ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    n_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    d_ff=10240,
    vocab=32000,
    ssm_state=64,
    ssm_head_dim=64,
    attn_every=6,          # shared block applied 9x
    tie_embeddings=True,
    quant=LUTQ_4BIT_POW2,
    act_bits=8,
))
