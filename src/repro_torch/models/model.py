"""The language model of the port, for the ``ssm`` family (Mamba-2).

The port of ``repro.models.model.LM``, restricted to the family the serving
path runs. Parameters keep the reference's tree keys and stacked
``[layers, ...]`` shapes (state-dict keys ``embed.tok``, ``mamba.in_x``, ...),
and the reference's ``lax.scan`` over layers is a loop over the layer
index. API:

  m = LM(cfg)                                  # on cuda, weights from seed 0
  logits = m.forward(batch)                    # prefill
  cache = m.init_cache(batch, max_seq)
  logits, cache = m.prefill(batch, cache)
  logits, cache = m.decode_step(cache, tokens) # tokens (B, 1)

As in the reference, ``prefill`` returns the forward logits and leaves an
SSM cache as it was; the serve loop fills the cache by teacher-forcing the
prompt through ``decode_step``. ``decode_step`` updates the cache tensors in
place (the reference returns new arrays) and returns the same dict.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as M

_CACHE_KEYS = ("conv_x", "conv_B", "conv_C", "ssm")


def _frozen(tree: Dict) -> nn.ParameterDict:
    return nn.ParameterDict({k: nn.Parameter(v, requires_grad=False)
                             for k, v in tree.items()})


class LM(nn.Module):
    def __init__(self, cfg: ModelConfig, device="cuda", seed: int = 0):
        super().__init__()
        if cfg.family != "ssm":
            raise NotImplementedError(
                f"family {cfg.family!r} is not ported yet: the port runs the "
                f"ssm family; ROADMAP.md queue 1, item 8 brings the others")
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("LM runs on cuda unless device='cpu' is "
                               "given, and this host has no CUDA GPU")
        self.cfg = cfg
        gen = torch.Generator(device=device).manual_seed(seed)
        self.embed = _frozen(L.embed_init(cfg, gen))
        self.mamba = _frozen(M.mamba_init(cfg, gen, cfg.layers))

    @property
    def device(self) -> torch.device:
        return self.embed["tok"].device

    def _layer(self, i: int) -> Dict[str, torch.Tensor]:
        return {k: v[i] for k, v in self.mamba.items()}

    def _embed(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.embed["tok"][tokens.to(self.device, torch.long)]

    def forward(self, batch: Dict) -> torch.Tensor:
        """Full-sequence logits (prefill). batch["tokens"]: (B, S)."""
        cfg = self.cfg
        h = self._embed(batch["tokens"])
        for i in range(cfg.layers):
            h = h + M.mamba_apply(cfg, self._layer(i), h)
        return L.logits_fn(cfg, self.embed, h)

    def init_cache(self, batch: int, max_seq: int) -> Dict:
        cfg = self.cfg
        cache = dict(pos=torch.zeros((), dtype=torch.int32,
                                     device=self.device))
        cache.update(M.mamba_cache_init(cfg, cfg.layers, batch,
                                        L.dtype_of(cfg), self.device))
        return cache

    def prefill(self, batch: Dict, cache: Dict) -> Tuple[torch.Tensor, Dict]:
        """The forward logits, and the cache unchanged (as the reference
        does for SSM families)."""
        return self.forward(batch), cache

    def decode_step(self, cache: Dict, tokens: torch.Tensor,
                    ) -> Tuple[torch.Tensor, Dict]:
        """One token step. tokens: (B, 1). Updates ``cache`` in place."""
        cfg = self.cfg
        h = self._embed(tokens)                          # (B, 1, D)
        for i in range(cfg.layers):
            out, new = M.mamba_step(cfg, self._layer(i), h,
                                    {k: cache[k][i] for k in _CACHE_KEYS})
            h = h + out
            for k in _CACHE_KEYS:
                cache[k][i].copy_(new[k])
        cache["pos"] += 1
        return L.logits_fn(cfg, self.embed, h), cache
