"""qwen1.5-110b [dense]: GQA with QKV bias.

80L d_model=8192 64H (GQA kv=8) d_ff=49152 vocab=152064 [hf:Qwen/Qwen1.5-0.5B; hf]
"""
from repro_torch.configs import register
from repro_torch.core.spec import LUTQ_4BIT_POW2
from repro_torch.models.config import ModelConfig

CONFIG = register(ModelConfig(
    name="qwen1.5-110b",
    family="dense",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=49152,
    vocab=152064,
    qkv_bias=True,
    rope_theta=1000000.0,
    tie_embeddings=False,
    quant=LUTQ_4BIT_POW2,
    act_bits=8,
))
