"""granite-8b [dense, code]: 36L d_model=4096 32H (kv=8) d_ff=14336
vocab 49152 [arXiv:2405.04324]."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-8b", family="dense", layers=36, d_model=4096,
    heads=32, kv_heads=8, d_ff=14336, vocab=49152,
)
