"""deepseek-v2-lite-16b [moe]: MLA (kv_lora=512) + fine-grained MoE.

27L d_model=2048 16H d_ff(expert)=1408 vocab=102400, 64 routed experts
top-6 + 2 shared, first layer dense [arXiv:2405.04434; hf]

Assignment note: the bracket text mentions "160 routed" (full V2); the
primary spec "MoE 64e top-6" (V2-Lite) is authoritative here.
"""
from repro_torch.configs import register
from repro_torch.core.spec import LUTQ_4BIT_POW2
from repro_torch.models.config import ModelConfig

CONFIG = register(ModelConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab=102400,
    tie_embeddings=False,
    use_mla=True,
    kv_lora=512,
    qk_nope=128,
    qk_rope=64,
    v_head=128,
    n_experts=64,
    top_k=6,
    n_shared_experts=2,
    d_ff_shared=2816,      # 2 shared experts x 1408
    first_dense=1,
    quant=LUTQ_4BIT_POW2,
    act_bits=8,
))
