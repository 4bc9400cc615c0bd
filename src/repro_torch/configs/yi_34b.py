"""yi-34b [dense]: 60L d_model=7168 56H (kv=8) d_ff=20480 vocab 64000
[arXiv:2403.04652]."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="yi-34b", family="dense", layers=60, d_model=7168,
    heads=56, kv_heads=8, d_ff=20480, vocab=64000, head_dim=128,
)
