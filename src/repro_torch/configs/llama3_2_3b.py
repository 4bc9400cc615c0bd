"""llama3.2-3b [dense]: 28L d_model=3072 24H (kv=8) d_ff=8192 vocab 128256
[hf:meta-llama/Llama-3.2-3B]."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama3.2-3b", family="dense", layers=28, d_model=3072,
    heads=24, kv_heads=8, d_ff=8192, vocab=128256, head_dim=128,
    rope_theta=5e5,
)
