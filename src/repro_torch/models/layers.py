"""Shared layers of the port's language models: the share the ``ssm``
family uses (dtype, RMSNorm, initialisation, embedding and logits).

The rounding follows the reference (``repro.models.layers``): ``rmsnorm``
normalises in float32, casts to ``x``'s dtype, then multiplies by ``w`` in
that dtype. Initialisation draws from an explicit ``torch.Generator``; it
cannot reproduce ``jax.random``, so tests carry the reference's parameters
across (``repro_torch.models.carry``).
"""

from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.base import ModelConfig


def dtype_of(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5):
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * w


def _init(gen: torch.Generator, shape, scale=None, dtype=torch.float32):
    scale = scale if scale is not None else 1.0 / (shape[-2] ** 0.5
                                                   if len(shape) > 1 else 1.0)
    out = torch.randn(shape, generator=gen, dtype=torch.float32,
                      device=gen.device)
    return (out * scale).to(dtype)


def embed_init(cfg: ModelConfig, gen: torch.Generator) -> Dict:
    dt = dtype_of(cfg)
    return dict(tok=_init(gen, (cfg.padded_vocab, cfg.d_model), scale=0.02,
                          dtype=dt),
                final_norm=torch.ones((cfg.d_model,), dtype=dt,
                                      device=gen.device))


def logits_fn(cfg: ModelConfig, emb: Dict, h: torch.Tensor) -> torch.Tensor:
    h = rmsnorm(h, emb["final_norm"], cfg.norm_eps)
    return h @ emb["tok"].T
