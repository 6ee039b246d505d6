"""mistral-nemo-12b [dense]: 128k-context dense transformer.

40L d_model=5120 32H (GQA kv=8) d_ff=14336 vocab=131072
[hf:mistralai/Mistral-Nemo-Base-2407; hf]
"""
from repro_torch.configs import register
from repro_torch.core.spec import LUTQ_4BIT_POW2
from repro_torch.models.config import ModelConfig

CONFIG = register(ModelConfig(
    name="mistral-nemo-12b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab=131072,
    head_dim=128,          # nemo: head_dim 128 (not d_model/n_heads=160)
    rope_theta=1000000.0,
    tie_embeddings=False,
    quant=LUTQ_4BIT_POW2,
    act_bits=8,
))
