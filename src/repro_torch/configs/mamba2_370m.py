"""mamba2-370m [ssm]: 48L d_model=1024, attention-free SSD, vocab 50280,
ssm_state=128 [arXiv:2405.21060]."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-370m", family="ssm", layers=48, d_model=1024,
    heads=0, kv_heads=0, d_ff=0, vocab=50280,
    ssm_state=128, ssm_heads=32, d_inner=2048, conv_kernel=4,
)
