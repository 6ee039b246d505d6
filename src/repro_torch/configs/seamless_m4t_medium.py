"""seamless-m4t-medium [audio]: enc-dec; the audio frontend is a stub
(callers pass precomputed frame embeddings, ``frames`` (B, S_src, D)).

12L enc + 12L dec, d_model=1024 16H d_ff=4096 vocab=256206
[arXiv:2308.11596; hf]
"""
from repro_torch.configs import register
from repro_torch.core.spec import LUTQ_4BIT_POW2
from repro_torch.models.config import ModelConfig

CONFIG = register(ModelConfig(
    name="seamless-m4t-medium",
    family="encdec",
    n_layers=12,           # decoder layers
    enc_layers=12,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab=256206,
    tie_embeddings=True,
    quant=LUTQ_4BIT_POW2,
    act_bits=8,
))
