"""The language model of the port, for every family of the reference:
``dense`` (Llama-style), ``vlm`` (the dense decoder with precomputed patch
embeddings prepended), ``moe`` (attention and a GShard mixture of
experts), ``ssm`` (Mamba-2), ``hybrid`` (Mamba-2 blocks with one shared
attention and MLP block every ``attn_period`` blocks) and ``encdec`` (a
non-causal encoder over precomputed frames, a decoder with
cross-attention to it).

The port of ``repro.models.model.LM``. Parameters keep the reference's tree
keys and stacked ``[layers, ...]`` shapes (state-dict keys ``embed.tok``,
``mamba.in_x``, ``attn.wq``, ``moe.router``, ``shared_attn.wq`` (one
layer), ``enc_attn.wq``, ``cross.wq``, ...), and the reference's
``lax.scan`` over layers is a loop over the layer index. API:

  m = LM(cfg)                                  # on cuda, weights from seed 0
  logits = m.forward(batch)                    # full sequence
  loss = m.loss(batch)                         # mean next-token xent
  cache = m.init_cache(batch, max_seq, enc_len=0)
  logits, cache = m.prefill(batch, cache)
  logits, cache = m.decode_step(cache, tokens) # tokens (B, 1)

``batch`` holds ``tokens`` (B, S), and ``patches`` (B, P, D) for a vlm
(optional, as in the reference) or ``frames`` (B, T, D) for an encdec.
``LM(cfg, remat="dots")`` recomputes each decoder layer in the backward
(``torch.utils.checkpoint``), as the reference's ``remat`` does with
``jax.checkpoint`` of its block; the default ``"none"`` keeps every
activation. ``LM(cfg, device="meta", seed=None)`` builds the shapes only
(every weight an empty tensor; the dry-run's abstract state).
``param_dims()`` and ``cache_dims()`` give the logical dims of the
sharding rules (``runtime.sharding``), keyed by state-dict name and cache
key.

On a mesh (parameters, batch and cache placed as DTensors by
``runtime.steps``) the same code runs on DTensors: ``pin`` redistributes
the residual stream at every residual add, each layer's weights are
gathered over the data axes for their use, and the ops DTensor has no
working strategy for run on local shards through ``local_map``
(``layers``, ``mamba2``, ``kernels.ops``).

``decode_step`` updates the cache tensors in place (the reference returns
new arrays) and returns the same dict. ``prefill`` returns the forward
logits; for the attention families (dense, vlm, moe, encdec) it also
writes every layer's RoPE'd k and its v at positions ``[0, S)`` of the
cache in the same pass (S counts a vlm's patches), sets ``pos = S`` and,
for an encdec, writes the encoder's output to ``cache["enc"]`` -- what the
reference's docstring promises and its code does not do (it sets ``pos``
and leaves k, v and ``enc`` at zero: ROADMAP queue 3, fault 4). As in the
reference, an ssm or hybrid cache is left as it was (fault 2); the serve
loop fills caches by teacher-forcing the prompt through ``decode_step``.

Every parameter is built with ``requires_grad=False``, so that serving
builds no autograd graph; a trainer turns gradients on with
``m.requires_grad_(True)``, as ``runtime.steps.make_train_step`` does.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as M
from repro_torch.runtime import sharding as shd

FAMILIES = ("dense", "vlm", "moe", "ssm", "hybrid", "encdec")
ATTENTION_FAMILIES = ("dense", "vlm", "moe", "encdec")
_SSM_CACHE_KEYS = ("conv_x", "conv_B", "conv_C", "ssm")


def _frozen(tree: Dict) -> nn.ParameterDict:
    return nn.ParameterDict({k: nn.Parameter(v, requires_grad=False)
                             for k, v in tree.items()})


def _slice(tree: nn.ParameterDict, i: int) -> Dict[str, torch.Tensor]:
    """Layer ``i``'s weights; on a mesh each is gathered over the data
    axes for this use (``layers.gather_fsdp``): ``layers`` is never split,
    so the slice itself stays local."""
    return {k: L.gather_fsdp(v[i]) for k, v in tree.items()}


def pin(x: torch.Tensor) -> torch.Tensor:
    """The reference's ``LM._pin``: on a mesh, (B, S, ...) batch-sharded
    over the data axes (the ``batch`` rule) and replicated over the rest,
    its gradient alike (``sharding.constrain``). The reference leaves
    ``d_model`` unconstrained; here it is replicated, so every layer starts
    from whole rows, and the partial sums that the column-split matmuls
    leave in the gradient on ``model`` are all-reduced here, once a layer.
    A plain tensor is returned as it is."""
    return shd.constrain(x, ("batch",) + (None,) * (x.dim() - 1))


class LM(nn.Module):
    def __init__(self, cfg: ModelConfig, device="cuda",
                 seed: Optional[int] = 0, remat: str = "none"):
        super().__init__()
        fam = cfg.family
        if remat not in ("none", "dots"):
            raise ValueError(f"remat {remat!r} is not 'none' or 'dots'")
        self.remat = remat
        if fam not in FAMILIES:
            raise NotImplementedError(
                f"family {fam!r} is not one of the reference's: "
                f"{', '.join(FAMILIES)}")
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("LM runs on cuda unless device='cpu' is "
                               "given, and this host has no CUDA GPU")
        self.cfg = cfg
        gen = L.NoDraw(device) if seed is None else \
            torch.Generator(device=device).manual_seed(seed)
        self.embed = _frozen(L.embed_init(cfg, gen))
        if fam in ("ssm", "hybrid"):
            self.mamba = _frozen(M.mamba_init(cfg, gen, cfg.layers))
        if fam == "hybrid":
            self.shared_attn = _frozen(L.attn_init(cfg, gen, 1))
            self.shared_mlp = _frozen(L.mlp_init(cfg, gen, 1))
        if fam == "encdec":
            self.enc_attn = _frozen(L.attn_init(cfg, gen, cfg.enc_layers))
            self.enc_mlp = _frozen(L.mlp_init(cfg, gen, cfg.enc_layers))
        if fam in ATTENTION_FAMILIES:
            self.attn = _frozen(L.attn_init(cfg, gen, cfg.layers))
        if fam == "encdec":
            self.cross = _frozen(L.attn_init(cfg, gen, cfg.layers))
        if fam == "moe":
            self.moe = _frozen(L.moe_init(cfg, gen, cfg.layers))
        if fam in ("dense", "vlm", "encdec") or \
                (fam == "moe" and cfg.dense_residual):
            self.mlp = _frozen(L.mlp_init(cfg, gen, cfg.layers))

    def param_dims(self) -> Dict[str, Tuple]:
        """The logical dims of every parameter, by state-dict name, for the
        sharding rules (``runtime.sharding``)."""
        groups = dict(embed=L.embed_dims(), mamba=M.mamba_dims(),
                      shared_attn=L.attn_dims(), shared_mlp=L.mlp_dims(),
                      enc_attn=L.attn_dims(), enc_mlp=L.mlp_dims(),
                      attn=L.attn_dims(), cross=L.attn_dims(),
                      moe=L.moe_dims(), mlp=L.mlp_dims())
        return {name: groups[name.split(".")[0]][name.split(".")[1]]
                for name, _ in self.named_parameters()}

    def cache_dims(self) -> Dict[str, Tuple]:
        """Logical dims of the cache tensors (for sharding rules)."""
        fam = self.cfg.family
        d: Dict = dict(pos=())
        if fam in ATTENTION_FAMILIES or fam == "hybrid":
            d["k"] = ("layers", "batch", "kv_heads", "kv_seq", None)
            d["v"] = ("layers", "batch", "kv_heads", "kv_seq", None)
        if fam == "encdec":
            d["enc"] = ("batch", None, None)
        if fam in ("ssm", "hybrid"):
            d["conv_x"] = ("layers", "batch", None, "d_inner")
            d["conv_B"] = ("layers", "batch", None, "bc_dim")
            d["conv_C"] = ("layers", "batch", None, "bc_dim")
            d["ssm"] = ("layers", "batch", "ssm_heads", None, None)
        return d

    @property
    def device(self) -> torch.device:
        return self.embed["tok"].device

    @property
    def num_attn_apps(self) -> int:
        """Applications of a hybrid's shared attention block."""
        cfg = self.cfg
        if cfg.family != "hybrid" or not cfg.attn_period:
            return 0
        return cfg.layers // cfg.attn_period

    def _embed(self, tokens: torch.Tensor) -> torch.Tensor:
        tok = L.gather_fsdp(self.embed["tok"])
        return L.embed_lookup(tok, tokens.to(self.device, torch.long))

    def _embed_inputs(self, batch: Dict) -> torch.Tensor:
        """(B, S, D): a vlm's patches, cast to the model's dtype, before the
        tokens' embeddings."""
        h = self._embed(batch["tokens"])
        if self.cfg.family == "vlm" and "patches" in batch:
            p = batch["patches"].to(self.device, h.dtype)
            h = torch.cat([p, h], dim=1)
        return h

    def forward(self, batch: Dict) -> torch.Tensor:
        """Full-sequence logits (B, S, V); a vlm's S counts its patches."""
        return self._forward(batch, None)

    def _forward(self, batch: Dict, cache: Optional[Dict]) -> torch.Tensor:
        with shd.implicit_replication(self.embed["tok"]):
            return self._forward_stack(batch, cache)

    def _forward_stack(self, batch: Dict, cache: Optional[Dict]):
        cfg = self.cfg
        h = pin(self._embed_inputs(batch))
        b, s, _ = h.shape
        pos = torch.arange(s, device=self.device).expand(b, s)
        if cfg.family == "ssm":
            for i in range(cfg.layers):
                h = pin(h + M.mamba_apply(cfg, _slice(self.mamba, i), h))
        elif cfg.family == "hybrid":
            h = self._hybrid_stack(h, pos)
        else:
            enc = None
            if cfg.family == "encdec":
                enc = self._encoder(batch["frames"])
                if cache is not None:
                    cache["enc"].copy_(enc)
            remat = self.remat != "none" and torch.is_grad_enabled()
            for i in range(cfg.layers):
                fill = None if cache is None else \
                    (cache["k"][i], cache["v"][i])
                if remat:
                    h = checkpoint(self._block, i, h, pos, enc, fill,
                                   use_reentrant=False)
                else:
                    h = self._block(i, h, pos, enc, fill)
        return L.logits_fn(cfg, self.embed, h)

    def _block(self, i, h, pos, enc, fill) -> torch.Tensor:
        """Decoder layer ``i``: self-attention, cross-attention to ``enc``
        (an encdec), the MLP or experts; each residual add pinned."""
        cfg = self.cfg
        h = pin(h + L.attn_apply(cfg, _slice(self.attn, i), h, pos,
                                 fill=fill))
        if enc is not None:
            h = pin(h + L.attn_apply(cfg, _slice(self.cross, i), h, pos,
                                     causal=False, kv=(enc,)))
        return pin(h + self._ffn(i, h))

    def _ffn(self, i: int, x: torch.Tensor) -> torch.Tensor:
        """Layer ``i``'s MLP, or its experts (plus the MLP beside them when
        ``dense_residual``)."""
        cfg = self.cfg
        if cfg.family != "moe":
            return L.mlp_apply(cfg, _slice(self.mlp, i), x)
        y = L.moe_apply(cfg, _slice(self.moe, i), x)
        if cfg.dense_residual:
            y = y + L.mlp_apply(cfg, _slice(self.mlp, i), x)
        return y

    def _encoder(self, frames: torch.Tensor) -> torch.Tensor:
        """The encoder's output (B, T, D): frames cast to the model's dtype,
        then ``enc_layers`` blocks of non-causal self-attention and MLP."""
        cfg = self.cfg
        h = frames.to(self.device, L.dtype_of(cfg))
        b, t, _ = h.shape
        pos = torch.arange(t, device=self.device).expand(b, t)
        for i in range(cfg.enc_layers):
            h = pin(h + L.attn_apply(cfg, _slice(self.enc_attn, i), h, pos,
                                     causal=False))
            h = pin(h + L.mlp_apply(cfg, _slice(self.enc_mlp, i), h))
        return h

    def _shared_block(self, h, pos, cache=None, app=0) -> torch.Tensor:
        """A hybrid's shared attention and MLP block; in decode, with the
        cache slot of application ``app``."""
        cfg = self.cfg
        lc = None if cache is None else \
            dict(k=cache["k"][app], v=cache["v"][app], pos=cache["pos"])
        h = pin(h + L.attn_apply(cfg, _slice(self.shared_attn, 0), h, pos,
                                 cache=lc))
        return pin(h + L.mlp_apply(cfg, _slice(self.shared_mlp, 0), h))

    def _hybrid_stack(self, h, pos) -> torch.Tensor:
        """``attn_period`` Mamba-2 blocks, then the shared block, applied
        ``num_attn_apps`` times; then the remaining Mamba-2 blocks."""
        cfg = self.cfg
        for i in range(cfg.layers):
            h = pin(h + M.mamba_apply(cfg, _slice(self.mamba, i), h))
            if cfg.attn_period and (i + 1) % cfg.attn_period == 0:
                h = self._shared_block(h, pos)
        return h

    def loss(self, batch: Dict) -> torch.Tensor:
        """Mean next-token cross entropy of ``forward(batch)``: the labels
        are ``tokens[:, 1:]`` followed by the last token again; a vlm's
        logits drop their patch positions first."""
        logits = self.forward(batch)
        with shd.implicit_replication(logits):
            tokens = batch["tokens"].to(self.device, torch.long)
            if self.cfg.family == "vlm" and "patches" in batch:
                logits = logits[:, batch["patches"].shape[1]:]
            labels = torch.cat([tokens[:, 1:], tokens[:, -1:]], dim=1)
            return L.xent_loss(self.cfg, logits, labels)

    def init_cache(self, batch: int, max_seq: int,
                   enc_len: int = 0) -> Dict:
        cfg = self.cfg
        dt = L.dtype_of(cfg)
        dev = self.device
        cache = dict(pos=torch.zeros((), dtype=torch.int32, device=dev))
        _, hkv_p, _ = L.padded_heads(cfg)
        if cfg.family in ATTENTION_FAMILIES:
            shape = (cfg.layers, batch, hkv_p, max_seq, cfg.hd)
            cache["k"] = torch.zeros(shape, dtype=dt, device=dev)
            cache["v"] = torch.zeros(shape, dtype=dt, device=dev)
        if cfg.family == "encdec":
            cache["enc"] = torch.zeros((batch, enc_len, cfg.d_model),
                                       dtype=dt, device=dev)
        if cfg.family in ("ssm", "hybrid"):
            cache.update(M.mamba_cache_init(cfg, cfg.layers, batch, dt, dev))
        if cfg.family == "hybrid":
            shape = (max(self.num_attn_apps, 1), batch, hkv_p, max_seq,
                     cfg.hd)
            cache["k"] = torch.zeros(shape, dtype=dt, device=dev)
            cache["v"] = torch.zeros(shape, dtype=dt, device=dev)
        return cache

    def prefill(self, batch: Dict, cache: Dict) -> Tuple[torch.Tensor, Dict]:
        """The forward logits; for the attention families the cache holds
        the prompt's k and v at ``[0, S)``, ``pos = S`` and an encdec's
        ``enc`` (module docstring); an ssm or hybrid cache is left as it
        was."""
        cfg = self.cfg
        if cfg.family not in ATTENTION_FAMILIES:
            return self.forward(batch), cache
        s = batch["tokens"].shape[1]
        if cfg.family == "vlm" and "patches" in batch:
            s += batch["patches"].shape[1]
        if s > cache["k"].shape[3]:
            raise ValueError(f"a prompt of {s} positions does not fit a "
                             f"cache of {cache['k'].shape[3]}")
        if cfg.family == "encdec" and \
                batch["frames"].shape[:2] != cache["enc"].shape[:2]:
            raise ValueError(f"frames {tuple(batch['frames'].shape)} do not "
                             f"fit the cache's enc "
                             f"{tuple(cache['enc'].shape)}: init_cache's "
                             f"enc_len is the frames' length")
        logits = self._forward(batch, cache)
        cache["pos"].fill_(s)
        return logits, cache

    def _mamba_step(self, i: int, h: torch.Tensor, cache: Dict):
        out, new = M.mamba_step(self.cfg, _slice(self.mamba, i), h,
                                {k: cache[k][i] for k in _SSM_CACHE_KEYS})
        for k in _SSM_CACHE_KEYS:
            cache[k][i].copy_(new[k])
        return pin(h + out)

    def decode_step(self, cache: Dict, tokens: torch.Tensor,
                    ) -> Tuple[torch.Tensor, Dict]:
        """One token step. tokens: (B, 1). Updates ``cache`` in place. A
        vlm decodes text only (the reference's has no patch path)."""
        with shd.implicit_replication(self.embed["tok"]):
            return self._decode_stack(cache, tokens)

    def _decode_stack(self, cache: Dict, tokens: torch.Tensor):
        cfg = self.cfg
        h = pin(self._embed(tokens))                     # (B, 1, D)
        pos = cache["pos"]
        positions = pos.long().expand(h.shape[0], 1)
        if cfg.family == "ssm":
            for i in range(cfg.layers):
                h = self._mamba_step(i, h, cache)
        elif cfg.family == "hybrid":
            for i in range(cfg.layers):
                h = self._mamba_step(i, h, cache)
                if cfg.attn_period and (i + 1) % cfg.attn_period == 0:
                    h = self._shared_block(h, positions, cache,
                                           (i + 1) // cfg.attn_period - 1)
        else:
            enc = cache.get("enc")
            for i in range(cfg.layers):
                lc = dict(k=cache["k"][i], v=cache["v"][i], pos=pos)
                h = pin(h + L.attn_apply(cfg, _slice(self.attn, i), h,
                                         positions, cache=lc))
                if enc is not None:
                    h = pin(h + L.attn_apply(cfg, _slice(self.cross, i), h,
                                             positions, causal=False,
                                             kv=(enc,)))
                h = pin(h + self._ffn(i, h))
        cache["pos"] += 1
        return L.logits_fn(cfg, self.embed, h), cache
