"""Model/arch configuration schema + the shape cells of the assignment."""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | encdec | vlm
    layers: int
    d_model: int
    heads: int
    kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None
    # --- MoE ---
    num_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    dense_residual: bool = False     # arctic: dense FFN in parallel with MoE
    capacity_factor: float = 1.25
    # --- SSM (Mamba-2 / SSD) ---
    ssm_state: int = 0
    ssm_heads: int = 0
    d_inner: int = 0
    conv_kernel: int = 4
    # --- hybrid (zamba2-style shared attention) ---
    attn_period: int = 0             # shared attn block after every N blocks
    # --- encoder-decoder (seamless-style; frontend stubbed) ---
    enc_layers: int = 0
    # --- vlm / audio stubs ---
    num_patches: int = 0             # prepended precomputed embeddings
    rope_theta: float = 1e4
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"
    # tensor-parallel head padding: q/kv heads are padded (kv by replication,
    # q by zero-weighted dummies) so the head dim divides the model axis —
    # the standard GQA-under-TP trick (Megatron/vLLM); tp_pad=1 disables.
    tp_pad: int = 16

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // max(self.heads, 1))

    @property
    def padded_vocab(self) -> int:
        """Vocab padded for clean model-axis sharding."""
        return -(-self.vocab // 256) * 256

    def scaled(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def smoke(self) -> "ModelConfig":
        """Reduced same-family config for CPU smoke tests."""
        kw = dict(layers=2, d_model=64, heads=4, kv_heads=2,
                  d_ff=128, vocab=512, head_dim=16, tp_pad=1)
        if self.family == "moe":
            kw.update(num_experts=4, top_k=min(2, self.top_k or 2),
                      moe_d_ff=64)
        if self.family in ("ssm", "hybrid"):
            kw.update(ssm_state=16, ssm_heads=4, d_inner=128, layers=3)
        if self.family == "hybrid":
            kw.update(attn_period=2, kv_heads=4)
        if self.family == "encdec":
            kw.update(enc_layers=2)
        if self.kv_heads == self.heads:
            kw["kv_heads"] = kw["heads"]
        if self.family == "vlm":
            kw.update(num_patches=8)
        return self.scaled(name=self.name + "-smoke", **kw)


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    """One (input-shape) cell of the assignment."""

    name: str
    kind: str          # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES: Dict[str, ShapeCell] = {
    "train_4k": ShapeCell("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeCell("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeCell("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeCell("long_500k", "decode", 524288, 1),
}

# long_500k needs sub-quadratic sequence handling; dense-attention archs skip
# it (noted in DESIGN.md §Arch-applicability)
LONG_CONTEXT_FAMILIES = ("ssm", "hybrid")
