"""paligemma-3b [vlm]: SigLIP frontend (a stub: callers pass precomputed
patch embeddings, ``prefix_embeds`` (B, 256, D)) + gemma LM backbone.

18L d_model=2048 8H (GQA kv=1, i.e. MQA) d_ff=16384 vocab=257216
[arXiv:2407.07726; hf]
"""
from repro_torch.configs import register
from repro_torch.core.spec import LUTQ_4BIT_POW2
from repro_torch.models.config import ModelConfig

CONFIG = register(ModelConfig(
    name="paligemma-3b",
    family="vlm",
    n_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv_heads=1,
    d_ff=16384,
    vocab=257216,
    head_dim=256,          # gemma-2b: 8 heads x 256
    tie_embeddings=True,
    n_prefix_tokens=256,   # 224x224 / 14x14 SigLIP patches
    quant=LUTQ_4BIT_POW2,
    act_bits=8,
))
