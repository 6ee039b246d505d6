"""qwen3-moe-235b-a22b [moe]: 128 experts top-8, qk-norm.

94L d_model=4096 64H (GQA kv=4) d_ff(expert)=1536 vocab=151936
[hf:Qwen/Qwen3-30B-A3B; hf]
"""
from repro_torch.configs import register
from repro_torch.core.spec import LUTQ_4BIT_POW2
from repro_torch.models.config import ModelConfig

CONFIG = register(ModelConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    n_layers=94,
    d_model=4096,
    n_heads=64,
    n_kv_heads=4,
    d_ff=1536,
    vocab=151936,
    head_dim=128,
    use_qk_norm=True,
    rope_theta=1000000.0,
    tie_embeddings=False,
    n_experts=128,
    top_k=8,
    quant=LUTQ_4BIT_POW2,
    act_bits=8,
))
