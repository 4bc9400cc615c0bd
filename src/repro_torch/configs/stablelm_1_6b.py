"""stablelm-1.6b [dense]: 24L d_model=2048 32H MHA d_ff=5632 vocab 100352
[hf:stabilityai/stablelm-2-1_6b]."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-1.6b", family="dense", layers=24, d_model=2048,
    heads=32, kv_heads=32, d_ff=5632, vocab=100352,
)
