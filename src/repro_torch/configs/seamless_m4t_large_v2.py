"""seamless-m4t-large-v2 [audio enc-dec]: 24L enc + 24L dec, d_model=1024,
16H (kv=16), d_ff=8192, vocab 256206 [arXiv:2308.11596]. The speech frontend
is a stub: input_specs supplies precomputed frame embeddings."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2", family="encdec", layers=24, d_model=1024,
    heads=16, kv_heads=16, d_ff=8192, vocab=256206, enc_layers=24,
)
