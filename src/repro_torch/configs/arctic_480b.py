"""arctic-480b [moe]: 35L d_model=7168 56H (kv=8) expert_ff=4864,
128 experts top-2 + dense residual FFN, vocab 32000
[hf:Snowflake/snowflake-arctic-base]."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="arctic-480b", family="moe", layers=35, d_model=7168,
    heads=56, kv_heads=8, d_ff=4864, vocab=32000,
    num_experts=128, top_k=2, moe_d_ff=4864, dense_residual=True,
)
