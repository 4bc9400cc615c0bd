"""The language model of the port, for the ``ssm`` (Mamba-2) and ``dense``
(Llama-style) families.

The port of ``repro.models.model.LM``, restricted to the families the serving
path runs. Parameters keep the reference's tree keys and stacked
``[layers, ...]`` shapes (state-dict keys ``embed.tok``, ``mamba.in_x``,
``attn.wq``, ``mlp.w1``, ...), and the reference's ``lax.scan`` over layers
is a loop over the layer index. API:

  m = LM(cfg)                                  # on cuda, weights from seed 0
  logits = m.forward(batch)                    # full sequence
  cache = m.init_cache(batch, max_seq)
  logits, cache = m.prefill(batch, cache)
  logits, cache = m.decode_step(cache, tokens) # tokens (B, 1)

``decode_step`` updates the cache tensors in place (the reference returns
new arrays) and returns the same dict. ``prefill`` returns the forward
logits; for the ``dense`` family it also writes every layer's RoPE'd k and
its v at positions ``[0, S)`` of the cache, in the same pass, and sets
``pos = S`` -- what the reference's docstring promises and its code does not
do (it sets ``pos`` and leaves k and v at zero: ROADMAP queue 3, fault 4).
As in the reference, an SSM cache is left as it was; the serve loop fills
caches by teacher-forcing the prompt through ``decode_step``.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as M

FAMILIES = ("ssm", "dense")
_SSM_CACHE_KEYS = ("conv_x", "conv_B", "conv_C", "ssm")


def _frozen(tree: Dict) -> nn.ParameterDict:
    return nn.ParameterDict({k: nn.Parameter(v, requires_grad=False)
                             for k, v in tree.items()})


def _slice(tree: nn.ParameterDict, i: int) -> Dict[str, torch.Tensor]:
    return {k: v[i] for k, v in tree.items()}


class LM(nn.Module):
    def __init__(self, cfg: ModelConfig, device="cuda", seed: int = 0):
        super().__init__()
        if cfg.family not in FAMILIES:
            raise NotImplementedError(
                f"family {cfg.family!r} is not ported yet: the port runs the "
                f"{' and '.join(FAMILIES)} families; ROADMAP.md queue 1, "
                f"item 8 brings the others")
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("LM runs on cuda unless device='cpu' is "
                               "given, and this host has no CUDA GPU")
        self.cfg = cfg
        gen = torch.Generator(device=device).manual_seed(seed)
        self.embed = _frozen(L.embed_init(cfg, gen))
        if cfg.family == "ssm":
            self.mamba = _frozen(M.mamba_init(cfg, gen, cfg.layers))
        else:
            self.attn = _frozen(L.attn_init(cfg, gen, cfg.layers))
            self.mlp = _frozen(L.mlp_init(cfg, gen, cfg.layers))

    @property
    def device(self) -> torch.device:
        return self.embed["tok"].device

    def _embed(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.embed["tok"][tokens.to(self.device, torch.long)]

    def forward(self, batch: Dict) -> torch.Tensor:
        """Full-sequence logits. batch["tokens"]: (B, S)."""
        return self._forward(batch, None)

    def _forward(self, batch: Dict, cache) -> torch.Tensor:
        cfg = self.cfg
        h = self._embed(batch["tokens"])
        if cfg.family == "ssm":
            for i in range(cfg.layers):
                h = h + M.mamba_apply(cfg, _slice(self.mamba, i), h)
        else:
            b, s, _ = h.shape
            pos = torch.arange(s, device=self.device).expand(b, s)
            for i in range(cfg.layers):
                fill = None if cache is None else \
                    (cache["k"][i], cache["v"][i])
                h = h + L.attn_apply(cfg, _slice(self.attn, i), h, pos,
                                     fill=fill)
                h = h + L.mlp_apply(cfg, _slice(self.mlp, i), h)
        return L.logits_fn(cfg, self.embed, h)

    def init_cache(self, batch: int, max_seq: int) -> Dict:
        cfg = self.cfg
        dt = L.dtype_of(cfg)
        cache = dict(pos=torch.zeros((), dtype=torch.int32,
                                     device=self.device))
        if cfg.family == "ssm":
            cache.update(M.mamba_cache_init(cfg, cfg.layers, batch, dt,
                                            self.device))
        else:
            _, hkv_p, _ = L.padded_heads(cfg)
            shape = (cfg.layers, batch, hkv_p, max_seq, cfg.hd)
            cache["k"] = torch.zeros(shape, dtype=dt, device=self.device)
            cache["v"] = torch.zeros(shape, dtype=dt, device=self.device)
        return cache

    def prefill(self, batch: Dict, cache: Dict) -> Tuple[torch.Tensor, Dict]:
        """The forward logits; for the dense family the cache holds the
        prompt's k and v at ``[0, S)`` and ``pos = S`` (module docstring),
        for the ssm family it is left as it was."""
        if self.cfg.family == "ssm":
            return self.forward(batch), cache
        s = batch["tokens"].shape[1]
        if s > cache["k"].shape[3]:
            raise ValueError(f"a prompt of {s} tokens does not fit a cache "
                             f"of {cache['k'].shape[3]}")
        logits = self._forward(batch, cache)
        cache["pos"].fill_(s)
        return logits, cache

    def decode_step(self, cache: Dict, tokens: torch.Tensor,
                    ) -> Tuple[torch.Tensor, Dict]:
        """One token step. tokens: (B, 1). Updates ``cache`` in place."""
        cfg = self.cfg
        h = self._embed(tokens)                          # (B, 1, D)
        if cfg.family == "ssm":
            for i in range(cfg.layers):
                out, new = M.mamba_step(
                    cfg, _slice(self.mamba, i), h,
                    {k: cache[k][i] for k in _SSM_CACHE_KEYS})
                h = h + out
                for k in _SSM_CACHE_KEYS:
                    cache[k][i].copy_(new[k])
        else:
            pos = cache["pos"]
            positions = pos.long().expand(h.shape[0], 1)
            for i in range(cfg.layers):
                lc = dict(k=cache["k"][i], v=cache["v"][i], pos=pos)
                h = h + L.attn_apply(cfg, _slice(self.attn, i), h,
                                     positions, cache=lc)
                h = h + L.mlp_apply(cfg, _slice(self.mlp, i), h)
        cache["pos"] += 1
        return L.logits_fn(cfg, self.embed, h), cache
