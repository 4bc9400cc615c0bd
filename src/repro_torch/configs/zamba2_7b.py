"""zamba2-7b [hybrid]: 81 Mamba2 blocks d_model=3584 + shared attention block
(32H kv=32, d_ff=14336) applied every 6 blocks, ssm_state=64
[arXiv:2411.15242]."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b", family="hybrid", layers=81, d_model=3584,
    heads=32, kv_heads=32, d_ff=14336, vocab=32000, head_dim=112,
    ssm_state=64, ssm_heads=56, d_inner=7168, conv_kernel=4, attn_period=6,
)
