"""granite-moe-1b-a400m [moe]: 24L d_model=1024 16H (kv=8) expert_ff=512,
32 experts top-8, vocab 49155 [hf:ibm-granite/granite-3.0-1b-a400m-base]."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m", family="moe", layers=24, d_model=1024,
    heads=16, kv_heads=8, d_ff=512, vocab=49155,
    num_experts=32, top_k=8, moe_d_ff=512,
)
