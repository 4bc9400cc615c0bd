"""Shared layers of the port's language models: dtype, RMSNorm, RoPE,
initialisation, the attention block (GQA, RoPE, KV cache, TP head padding,
cross-attention), the SwiGLU MLP, the mixture of experts, embedding,
logits and the cross-entropy loss.

The port of ``repro.models.layers``. The rounding follows the reference:
``rmsnorm`` normalises in float32, casts to ``x``'s dtype, then multiplies
by ``w`` in that dtype; ``rope`` rotates in float32 and casts back.
Initialisation draws from an explicit ``torch.Generator``; it cannot
reproduce ``jax.random``, so tests carry the reference's parameters across
(``repro_torch.models.carry``).

Attention keeps the reference's layout: q, k and v are ``(B, H, S, hd)``
(here views of the ``(B, S, H, hd)`` projections: K2 reads them by strides)
and the cache is ``(B, Hkv_p, T, hd)`` per layer. A prefill, the encoder's
self-attention and every cross-attention (decode's too: S = 1 against the
encoder's T) go through ``ops.attention`` (K2 on the card); cached decode
self-attention through the plain ``_masked_decode_attention``, as in the
reference. Unlike the reference, the decode path writes the new k and v
into the cache in place (``index_copy_`` on a device index: no host sync),
a prefill can fill the cache in the same pass (``fill``), and ``attn_init``
draws at the fan-in scale (``attn_init`` says why).

``moe_apply`` computes the reference's GShard dispatch (top-k of the
float32 router's softmax, renormalised gates, a capacity per expert and
batch row, arrival order within an expert's queue, drops past the
capacity) by index: the kept (token, choice) pairs are scattered into the
experts' capacity slots and gathered back, where the reference multiplies
by one-hot ``(B, S, E, C)`` dispatch and combine tensors.
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


def silu(x: torch.Tensor) -> torch.Tensor:
    """``x * sigmoid(x)``, the sigmoid as ``1 / (1 + exp(-x))`` op by op in
    ``x``'s dtype: ``jax.nn.silu``'s rounding. In bfloat16 ``F.silu``
    rounds once, and differs from the reference in a third of the values
    by an ulp; the bf16 parity tests need the reference's rounding. On the
    card it costs four elementwise passes more than ``F.silu`` (PERF.md
    §6)."""
    return x * torch.reciprocal(1 + torch.exp(-x))


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


def xent_loss(cfg: ModelConfig, logits: torch.Tensor,
              labels: torch.Tensor) -> torch.Tensor:
    """Mean next-token cross entropy in float32 over the padded vocab:
    ``logsumexp`` minus the gold logit. The reference takes the gold logit
    by a float32 one-hot contraction (for vocab sharding); ``gather`` gives
    the same value, the sum having one non-zero term, without the one-hot
    (525 MB at llama3.2-3b's 8 x 128 x 128,256)."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    gold = lf.gather(-1, labels.to(lf.device, torch.long)[..., None])[..., 0]
    return torch.mean(lse - gold)


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
               positions: torch.Tensor, causal: bool = True,
               kv: Optional[Tuple[torch.Tensor]] = None,
               cache: Optional[Dict] = None,
               fill: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
               ) -> torch.Tensor:
    """One attention block (pre-norm, residual outside). x: (B, S, D);
    positions: (B, S) int64.

    kv: ``(enc,)``, the encoder states (B, T, D) for cross-attention: k and
    v are projected from them, nothing is rotated, and every query sees
    every key. Otherwise this is self-attention with q and k rotated,
    causal unless ``causal=False`` (the encoder). cache: dict(k, v, pos)
    for decode, k/v one layer's (B, Hkv_p, T, hd); the new k and v are
    written at ``positions[0]`` in place and the block attends to the keys
    before ``pos + S``. fill: one layer's (k, v) cache tensors, which
    receive this pass's k and v at ``[0, S)`` (prefill)."""
    b, s, _ = x.shape
    hd = cfg.hd
    hq_p, hkv_p, _ = padded_heads(cfg)
    h = rmsnorm(x, p["norm"], cfg.norm_eps)
    src = h if kv is None else kv[0]
    kv_len = src.shape[1]
    q = (h @ p["wq"]).reshape(b, s, hq_p, hd)
    k = (src @ p["wk"]).reshape(b, kv_len, hkv_p, hd)
    v = (src @ p["wv"]).reshape(b, kv_len, hkv_p, hd)
    if kv is None:                     # self-attention: rotate q and k
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
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
        out = ops.attention(q, k, v, causal=causal and kv is None)
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

def mlp_init(cfg: ModelConfig, gen: torch.Generator, layers: int,
             d_ff: Optional[int] = None) -> Dict:
    d_ff = d_ff or cfg.d_ff
    dt = dtype_of(cfg)
    return dict(w1=_init(gen, (layers, cfg.d_model, d_ff), dtype=dt),
                w3=_init(gen, (layers, cfg.d_model, d_ff), dtype=dt),
                w2=_init(gen, (layers, d_ff, cfg.d_model), dtype=dt),
                norm=torch.ones((layers, cfg.d_model), dtype=dt,
                                device=gen.device))


def mlp_apply(cfg: ModelConfig, p: Dict, x: torch.Tensor) -> torch.Tensor:
    h = rmsnorm(x, p["norm"], cfg.norm_eps)
    return (silu(h @ p["w1"]) * (h @ p["w3"])) @ p["w2"]


# ---------------------------------------------------------------------------
# Mixture of experts (GShard-style capacity dispatch)
# ---------------------------------------------------------------------------

def moe_init(cfg: ModelConfig, gen: torch.Generator, layers: int) -> Dict:
    """The router is float32 in every model dtype, as in the reference."""
    e, f, dm = cfg.num_experts, cfg.moe_d_ff or cfg.d_ff, cfg.d_model
    dt = dtype_of(cfg)
    return dict(router=_init(gen, (layers, dm, e)),
                w1=_init(gen, (layers, e, dm, f), dtype=dt),
                w3=_init(gen, (layers, e, dm, f), dtype=dt),
                w2=_init(gen, (layers, e, f, dm), dtype=dt),
                norm=torch.ones((layers, dm), dtype=dt, device=gen.device))


def capacity(cfg: ModelConfig, s: int) -> int:
    """Slots per expert and batch row for a sequence of ``s`` tokens."""
    return max(1, int(cfg.capacity_factor * s * cfg.top_k / cfg.num_experts))


def moe_route(cfg: ModelConfig, p: Dict, h: torch.Tensor):
    """The routing of the normed states ``h`` (B, S, D): (gates (B, S, E)
    float32, top-k experts (B, S, k) int64, their renormalised weights,
    each choice's arrival index in its expert's queue, kept = index below
    the capacity). Ties between gates go to the lower expert index, as
    ``lax.top_k`` breaks them (a stable descending sort)."""
    b, s, _ = h.shape
    e, k = cfg.num_experts, cfg.top_k
    gates = torch.softmax(h.float() @ p["router"], dim=-1)
    topv, topi = torch.sort(gates, dim=-1, descending=True, stable=True)
    topv, topi = topv[..., :k], topi[..., :k]
    topv = topv / (topv.sum(dim=-1, keepdim=True) + 1e-9)
    # arrival order: token by token, and choice by choice within a token;
    # the count runs along the last dim (a scan along dim 1 of (B, S*k, E)
    # took half of granite-moe-1b-a400m's prefill on the card)
    flat = topi.reshape(b, 1, s * k)
    onehot = F.one_hot(flat[:, 0], e).transpose(1, 2).contiguous()
    arrival = (onehot.cumsum(dim=-1) - onehot).gather(1, flat) \
        .reshape(b, s, k)                                   # (B, E, S*k)
    return gates, topi, topv, arrival, arrival < capacity(cfg, s)


def moe_apply(cfg: ModelConfig, p: Dict, x: torch.Tensor) -> torch.Tensor:
    """Top-k capacity dispatch: within a batch row each expert takes at most
    ``capacity`` (token, choice) pairs in arrival order and drops the rest
    (module docstring)."""
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.top_k
    cap = capacity(cfg, s)
    h = rmsnorm(x, p["norm"], cfg.norm_eps)
    _, topi, topv, arrival, keep = moe_route(cfg, p, h)
    # each (token, choice) pair's slot in its expert's queue; a dropped pair
    # goes to a spare slot ``cap`` that no expert reads (no host sync)
    slot = torch.where(keep, arrival, cap)
    rows = torch.arange(b, device=h.device)[:, None, None].expand(b, s, k)
    xin = torch.zeros((e, b, cap + 1, d), dtype=h.dtype, device=h.device)
    xin[topi, rows, slot] = h[:, :, None, :].expand(b, s, k, d)
    xin = xin[:, :, :cap].reshape(e, b * cap, d)
    hmid = silu(torch.bmm(xin, p["w1"])) * torch.bmm(xin, p["w3"])
    xout = torch.bmm(hmid, p["w2"]).reshape(e, b, cap, d)
    out = xout[topi, rows, slot.clamp(max=cap - 1)].float()   # (B, S, k, D)
    y = ((topv * keep)[..., None] * out).sum(dim=2)
    return y.to(x.dtype)
