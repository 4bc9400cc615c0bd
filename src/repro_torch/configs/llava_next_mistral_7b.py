"""llava-next-mistral-7b [vlm]: mistral-7b backbone 32L d_model=4096 32H
(kv=8) d_ff=14336 vocab 32000; anyres patch embeddings stubbed (precomputed,
num_patches prepended) [hf:llava-hf/llava-v1.6-mistral-7b-hf]."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-mistral-7b", family="vlm", layers=32, d_model=4096,
    heads=32, kv_heads=8, d_ff=14336, vocab=32000, head_dim=128,
    num_patches=256,
)
