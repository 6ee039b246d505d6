"""mistral-large-123b [dense]: 96 query heads over 8 KV heads, a group
of 12.

88L d_model=12288 96H (GQA kv=8) d_ff=28672 vocab=32768
[hf:mistralai/Mistral-Large-Instruct-2407; unverified]
"""
from repro_torch.configs import register
from repro_torch.core.spec import LUTQ_4BIT_POW2
from repro_torch.models.config import ModelConfig

CONFIG = register(ModelConfig(
    name="mistral-large-123b",
    family="dense",
    n_layers=88,
    d_model=12288,
    n_heads=96,
    n_kv_heads=8,
    d_ff=28672,
    vocab=32768,
    head_dim=128,
    rope_theta=1000000.0,
    tie_embeddings=False,
    quant=LUTQ_4BIT_POW2,
    act_bits=8,
))
