"""Shared layers of the port's language models: dtype, RMSNorm, RoPE,
initialisation, the attention block (GQA, RoPE, KV cache, TP head padding),
the SwiGLU MLP, embedding and logits.

The port of ``repro.models.layers`` for the ``ssm`` and ``dense`` families.
The rounding follows the reference: ``rmsnorm`` normalises in float32,
casts to ``x``'s dtype, then multiplies by ``w`` in that dtype; ``rope``
rotates in float32 and casts back. Initialisation draws from an explicit
``torch.Generator``; it cannot reproduce ``jax.random``, so tests carry the
reference's parameters across (``repro_torch.models.carry``).

Attention keeps the reference's layout: q, k and v are ``(B, H, S, hd)``
(here views of the ``(B, S, H, hd)`` projections: K2 reads them by strides)
and the cache is ``(B, Hkv_p, T, hd)`` per layer. A prefill goes through
``ops.attention`` (K2 on the card), decode through the plain
``_masked_decode_attention``, as in the reference. Unlike the reference, the
decode path writes the new k and v into the cache in place (``index_copy_``
on a device index: no host sync), a prefill can fill the cache in the same
pass (``fill``), and ``attn_init`` draws at the fan-in scale (``attn_init``
says why).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops


def dtype_of(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5):
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * w


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """x: (..., S, H, D); positions: (..., S)."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    angles = positions[..., None].float() * freqs      # (..., S, half)
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


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


# ---------------------------------------------------------------------------
# Attention block (GQA + RoPE + KV cache) with TP head padding
# ---------------------------------------------------------------------------

def padded_heads(cfg: ModelConfig) -> Tuple[int, int, int]:
    """(hq_p, hkv_p, group_p) after TP padding, as the reference: kv heads
    are replicated up to a multiple of ``tp_pad``; q heads are placed so that
    each still reads its own kv head, and zero-weighted dummy q slots fill
    the rectangle."""
    tp = max(cfg.tp_pad, 1)
    hq, hkv = cfg.heads, cfg.kv_heads
    if hq == 0:
        return 0, 0, 0
    if tp == 1:
        return hq, hkv, hq // hkv
    hkv_p = hkv if hkv % tp == 0 else -(-hkv // tp) * tp \
        if hkv > tp else tp
    rep = hkv_p // hkv
    g0 = hq // hkv
    g_p = -(-g0 // rep)
    return hkv_p * g_p, hkv_p, g_p


def _head_maps(cfg: ModelConfig) -> Tuple[np.ndarray, np.ndarray]:
    """(q_slot[orig_q] -> padded slot, kv_of[padded_kv] -> orig kv)."""
    hq, hkv = cfg.heads, cfg.kv_heads
    hq_p, hkv_p, g_p = padded_heads(cfg)
    rep = hkv_p // hkv
    g0 = hq // hkv
    q_slot = np.full(hq, -1, np.int64)
    for j in range(hkv):
        for c in range(rep):
            lo = j * g0 + c * g_p
            hi = min(j * g0 + (c + 1) * g_p, (j + 1) * g0)
            for t, i in enumerate(range(lo, hi)):
                q_slot[i] = (j * rep + c) * g_p + t
    kv_of = np.repeat(np.arange(hkv), rep)
    return q_slot, kv_of


def attn_init(cfg: ModelConfig, gen: torch.Generator, layers: int) -> Dict:
    hd, dm = cfg.hd, cfg.d_model
    dt = dtype_of(cfg)
    dev = gen.device
    hq_p, hkv_p, _ = padded_heads(cfg)
    q_slot, kv_of = (torch.from_numpy(a).to(dev) for a in _head_maps(cfg))
    # draw in original head space, then place into padded slots. The scales
    # are the fan-ins; the reference's _init takes shape[-2] of these 4-d
    # draws (the head count, or hd for wo), which makes q and k 11x too
    # large at llama3.2-3b and its attention a hard max (ROADMAP queue 3,
    # fault 5; chip_smoke.py's phase_reference_init measures it at full
    # width). Carried weights are unaffected.
    s_in, s_out = dm ** -0.5, (cfg.heads * hd) ** -0.5
    wq0 = _init(gen, (layers, dm, cfg.heads, hd), s_in, dt)
    wk0 = _init(gen, (layers, dm, cfg.kv_heads, hd), s_in, dt)
    wv0 = _init(gen, (layers, dm, cfg.kv_heads, hd), s_in, dt)
    wo0 = _init(gen, (layers, cfg.heads, hd, dm), s_out, dt)
    wq = torch.zeros((layers, dm, hq_p, hd), dtype=dt, device=dev)
    wq[:, :, q_slot] = wq0
    wo = torch.zeros((layers, hq_p, hd, dm), dtype=dt, device=dev)
    wo[:, q_slot] = wo0
    return dict(
        wq=wq.reshape(layers, dm, hq_p * hd),
        wk=wk0[:, :, kv_of].reshape(layers, dm, hkv_p * hd),
        wv=wv0[:, :, kv_of].reshape(layers, dm, hkv_p * hd),
        wo=wo.reshape(layers, hq_p * hd, dm),
        norm=torch.ones((layers, dm), dtype=dt, device=dev),
    )


def attn_apply(cfg: ModelConfig, p: Dict, x: torch.Tensor,
               positions: torch.Tensor, cache: Optional[Dict] = None,
               fill: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
               ) -> torch.Tensor:
    """One causal self-attention block (pre-norm, residual outside).
    x: (B, S, D); positions: (B, S) int64.

    cache: dict(k, v, pos) for decode, k/v one layer's (B, Hkv_p, T, hd);
    the new k and v are written at ``positions[0]`` in place and the block
    attends to the keys before ``pos + S``. fill: one layer's (k, v) cache
    tensors, which receive this pass's k and v at ``[0, S)`` (prefill)."""
    b, s, _ = x.shape
    hd = cfg.hd
    hq_p, hkv_p, _ = padded_heads(cfg)
    h = rmsnorm(x, p["norm"], cfg.norm_eps)
    q = rope((h @ p["wq"]).reshape(b, s, hq_p, hd), positions, cfg.rope_theta)
    k = rope((h @ p["wk"]).reshape(b, s, hkv_p, hd), positions,
             cfg.rope_theta)
    v = (h @ p["wv"]).reshape(b, s, hkv_p, hd)
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))   # (B, H, S, hd) views
    if cache is not None:
        idx = positions[0]
        cache["k"].index_copy_(2, idx, k)
        cache["v"].index_copy_(2, idx, v)
        out = _masked_decode_attention(q, cache["k"], cache["v"],
                                       cache["pos"] + s)
    else:
        if fill is not None:
            fill[0][:, :, :s].copy_(k)
            fill[1][:, :, :s].copy_(v)
        out = ops.attention(q, k, v, causal=True)
    return out.transpose(1, 2).reshape(b, s, hq_p * hd) @ p["wo"]


def _masked_decode_attention(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor,
                             valid_len: torch.Tensor) -> torch.Tensor:
    """Attention with keys masked at and beyond ``valid_len`` (a device
    scalar; static cache layout)."""
    b, hq, s, d = q.shape
    hkv, t = k.shape[1], k.shape[2]
    qf = q.float().reshape(b, hkv, hq // hkv, s, d)
    logits = torch.einsum("bhgsd,bhtd->bhgst", qf, k.float())
    logits = logits * (1.0 / d ** 0.5)
    mask = torch.arange(t, device=q.device) < valid_len
    logits = torch.where(mask, logits, torch.full((), -1e30,
                                                  device=q.device))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgst,bhtd->bhgsd", probs, v.float())
    return out.reshape(b, hq, s, d).to(q.dtype)


# ---------------------------------------------------------------------------
# SwiGLU MLP
# ---------------------------------------------------------------------------

def mlp_init(cfg: ModelConfig, gen: torch.Generator, layers: int) -> Dict:
    d_ff = cfg.d_ff
    dt = dtype_of(cfg)
    return dict(w1=_init(gen, (layers, cfg.d_model, d_ff), dtype=dt),
                w3=_init(gen, (layers, cfg.d_model, d_ff), dtype=dt),
                w2=_init(gen, (layers, d_ff, cfg.d_model), dtype=dt),
                norm=torch.ones((layers, cfg.d_model), dtype=dt,
                                device=gen.device))


def mlp_apply(cfg: ModelConfig, p: Dict, x: torch.Tensor) -> torch.Tensor:
    h = rmsnorm(x, p["norm"], cfg.norm_eps)
    return (F.silu(h @ p["w1"]) * (h @ p["w3"])) @ p["w2"]
