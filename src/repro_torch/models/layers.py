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
from torch.distributed.tensor import DTensor

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


def split_heads(t: torch.Tensor, heads: int) -> torch.Tensor:
    """(..., heads * d) -> (..., heads, d). On a mesh, DTensor cannot view
    a last dim that a mesh axis splits into parts of partial heads (the
    reference's GSPMD splits mid-head): that axis is gathered first, so
    its ranks hold whole heads."""
    if isinstance(t, DTensor):
        from torch.distributed.tensor import Replicate, Shard

        last = t.dim() - 1
        pl = [Replicate() if isinstance(p, Shard) and p.dim == last and
              heads % t.device_mesh.size(i) else p
              for i, p in enumerate(t.placements)]
        if pl != list(t.placements):
            t = t.redistribute(t.device_mesh, pl)
    return t.reshape(*t.shape[:-1], heads, t.shape[-1] // heads)


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


class NoDraw:
    """Stands in for the generator where weights need shapes only (the
    dry-run's abstract state): ``_init`` then returns an empty tensor on
    ``device``, ``meta`` or a fake tensor's, and draws nothing."""

    def __init__(self, device):
        self.device = torch.device(device)


def _init(gen: torch.Generator, shape, scale=None, dtype=torch.float32):
    if isinstance(gen, NoDraw):
        return torch.empty(shape, dtype=dtype, device=gen.device)
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


def embed_dims() -> Dict:
    return dict(tok=("vocab", "d_model"), final_norm=(None,))


def gather_fsdp(w: torch.Tensor) -> torch.Tensor:
    """On a mesh, a weight made whole over the data axes (its FSDP shards
    gathered for this use, as GSPMD does in the reference) and still split
    over ``model``; a plain tensor as it is. Its gradient goes back to the
    shards by a reduce-scatter (the redistribution's backward)."""
    if not isinstance(w, DTensor):
        return w
    from torch.distributed.tensor import Replicate

    names = w.device_mesh.mesh_dim_names
    pl = [Replicate() if names[i] in ("pod", "data") else p
          for i, p in enumerate(w.placements)]
    return w if pl == list(w.placements) else \
        w.redistribute(w.device_mesh, pl)


def embed_lookup(tok: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``tok[ids]``. On a mesh (``tok`` gathered over the data axes, its
    vocab split over ``model`` by the ``vocab`` rule; ``ids``
    batch-sharded) it runs on local shards through ``local_map``: each
    rank of the model axis looks up the ids in its vocab shard and gives
    zeros for the others, a ``Partial`` sum over ``model`` that the
    caller's ``pin`` all-reduces. DTensor's own ``index`` strategy leaves
    a gradient whose ``index_put`` some torch versions cannot place."""
    if not isinstance(tok, DTensor):
        return tok[ids]
    from torch.distributed.tensor import Partial, Shard
    from torch.distributed.tensor.experimental import local_map
    from repro_torch.runtime import sharding as shd

    mesh = tok.device_mesh
    names = mesh.mesh_dim_names
    ip = shd.placements(mesh, shd.spec_for(
        mesh, ("batch",) + (None,) * (ids.dim() - 1), ids.shape))
    split = [i for i, p in enumerate(tok.placements)
             if p == Shard(0) and mesh.size(i) > 1]
    out = [Partial() if i in split else p for i, p in enumerate(ip)]
    first, v_here = 0, tok.shape[0]
    if split:
        (i,) = split
        v_here //= mesh.size(i)
        first = mesh.get_local_rank(names[i]) * v_here

    def local(t, x):
        if not split:
            return t[x]
        here = (x >= first) & (x < first + v_here)
        rows = t[torch.where(here, x - first, 0)]
        return torch.where(here[..., None], rows, 0.0).to(t.dtype)

    pls = (list(tok.placements), list(ip))
    return local_map(local, out_placements=out, in_placements=pls,
                     in_grad_placements=shd.grad_placements(pls),
                     device_mesh=mesh, redistribute_inputs=True)(tok, ids)


def logits_fn(cfg: ModelConfig, emb: Dict, h: torch.Tensor) -> torch.Tensor:
    h = rmsnorm(h, emb["final_norm"], cfg.norm_eps)
    return h @ gather_fsdp(emb["tok"]).T


def xent_loss(cfg: ModelConfig, logits: torch.Tensor,
              labels: torch.Tensor) -> torch.Tensor:
    """Mean next-token cross entropy in float32 over the padded vocab:
    ``logsumexp`` minus the gold logit. The reference takes the gold logit
    by a float32 one-hot contraction (for vocab sharding); ``gather`` gives
    the same value, the sum having one non-zero term, without the one-hot
    (525 MB at llama3.2-3b's 8 x 128 x 128,256)."""
    if isinstance(logits, DTensor):
        return _xent_sharded(cfg, logits, labels)
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    gold = lf.gather(-1, labels.to(lf.device, torch.long)[..., None])[..., 0]
    return torch.mean(lse - gold)


def _xent_sharded(cfg: ModelConfig, logits: torch.Tensor,
                  labels: torch.Tensor) -> torch.Tensor:
    """``xent_loss`` on a mesh: logits (B, S, V) batch-sharded over the data
    axes and, by the ``vocab`` rule, split in V over ``model``, as they
    leave ``logits_fn``; labels batch-sharded. Where V is not split over
    more than one rank, the plain loss runs on each batch shard through
    ``local_map`` (so a 1 x 1 mesh computes it bit for bit). Otherwise the
    vocab-parallel form: the max and the sum of exponentials reduce over
    the vocab shards (DTensor all-reduces them), and the gold logit comes
    from the one shard that holds each label (``local_map``, summed over
    ``model``), since DTensor's ``gather`` on a split dim has no working
    strategy here. The result: the mean over the batch shard, averaged
    over the data axes."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    from repro_torch.runtime import sharding as shd

    mesh = logits.device_mesh
    names = mesh.mesh_dim_names
    lp = shd.placements(mesh, shd.spec_for(mesh, ("batch", None, "vocab"),
                                           logits.shape))
    logits = logits.redistribute(mesh, lp)
    bp = [Shard(0) if p == Shard(0) else Replicate() for p in lp]
    split = [i for i, p in enumerate(lp) if p == Shard(2) and mesh.size(i) > 1]
    labels = labels.to(torch.long).redistribute(mesh, bp)
    mean = [Partial("avg") if p == Shard(0) else Replicate() for p in lp]
    if not split:
        return local_map(lambda lg, lb: xent_loss(cfg, lg, lb),
                         out_placements=mean, in_placements=(lp, bp),
                         device_mesh=mesh)(logits, labels)
    lf = logits.float()
    m = lf.detach().amax(dim=-1, keepdim=True)
    lse = torch.log(torch.exp(lf - m).sum(dim=-1)) + m[..., 0]
    (i,) = split
    v_here = logits.shape[-1] // mesh.size(i)
    first = mesh.get_local_rank(names[i]) * v_here

    def gold_here(lg, lb):
        here = (lb >= first) & (lb < first + v_here)
        g = lg.gather(-1, torch.where(here, lb - first, 0)[..., None])
        return torch.where(here, g[..., 0], 0.0)

    gp = [Partial() if j == i else p for j, p in enumerate(bp)]
    gold = local_map(gold_here, out_placements=gp, in_placements=(lp, bp),
                     device_mesh=mesh)(lf, labels)
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


def attn_dims() -> Dict:
    return dict(wq=("layers", "d_model", "heads_x_hd"),
                wk=("layers", "d_model", "kv_x_hd"),
                wv=("layers", "d_model", "kv_x_hd"),
                wo=("layers", "heads_x_hd", "d_model"),
                norm=("layers", None))


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
    q = split_heads(h @ p["wq"], hq_p)
    k = split_heads(src @ p["wk"], hkv_p)
    v = split_heads(src @ p["wv"], hkv_p)
    if kv is None:                     # self-attention: rotate q and k
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))   # (B, H, S, hd) views
    if cache is not None:
        out = _cached_attention(q, k, v, cache["k"], cache["v"],
                                positions[0], cache["pos"] + s)
    else:
        if fill is not None:
            fill[0][:, :, :s].copy_(k)
            fill[1][:, :, :s].copy_(v)
        out = ops.attention(q, k, v, causal=causal and kv is None)
    return out.transpose(1, 2).reshape(b, s, hq_p * hd) @ p["wo"]


def _cached_attention(q, k, v, ck, cv, idx, valid_len) -> torch.Tensor:
    """Write this step's k and v at positions ``idx`` of one layer's cache
    (``ck``, ``cv``: (B, Hkv_p, T, hd)) in place, then attend to the keys
    before ``valid_len``.

    On a mesh it runs on local shards through ``local_map``: the cache
    keeps the placements ``cache_shardings`` gave it (a redistributed copy
    would take the write), and q, k and v are redistributed to match it,
    batch and heads alike; ``idx`` and ``valid_len`` are replicated. A
    cache whose sequence dim is sharded (``kv_seq`` or ``long_seq`` on a
    mesh axis) would need a softmax across ranks and raises
    ``NotImplementedError``; with ``tp_pad`` 16, every configuration's kv
    heads split over a model axis of 16, and the rules then leave the
    sequence whole."""
    if isinstance(ck, DTensor):
        from torch.distributed.tensor import Replicate, Shard
        from torch.distributed.tensor.experimental import local_map

        pl = list(ck.placements)
        if any(isinstance(x, Shard) and x.dim >= 2 for x in pl):
            raise NotImplementedError(
                f"decode attention on a cache sharded along its sequence "
                f"({ck.placements}): a softmax across ranks is not ported")
        whole = [Replicate()] * len(pl)
        return local_map(_cached_attention, out_placements=pl,
                         in_placements=(pl,) * 5 + (whole, whole),
                         device_mesh=ck.device_mesh,
                         redistribute_inputs=True)(q, k, v, ck, cv, idx,
                                                   valid_len)
    ck.index_copy_(2, idx, k)
    cv.index_copy_(2, idx, v)
    return _masked_decode_attention(q, ck, cv, valid_len)


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


def mlp_dims() -> Dict:
    return dict(w1=("layers", "d_model", "d_ff"),
                w3=("layers", "d_model", "d_ff"),
                w2=("layers", "d_ff", "d_model"),
                norm=("layers", None))


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


def moe_dims() -> Dict:
    return dict(router=("layers", "d_model", None),
                w1=("layers", "experts", "d_model", "expert_ff"),
                w3=("layers", "experts", "d_model", "expert_ff"),
                w2=("layers", "experts", "expert_ff", "d_model"),
                norm=("layers", None))


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


def moe_apply(cfg: ModelConfig, p: Dict, x: torch.Tensor,
              first_expert: int = 0) -> torch.Tensor:
    """Top-k capacity dispatch: within a batch row each expert takes at most
    ``capacity`` (token, choice) pairs in arrival order and drops the rest
    (module docstring). On a mesh see ``moe_sharded``; there ``p`` holds
    the experts ``first_expert, ...`` of one shard, and the pairs routed to
    other experts add nothing here."""
    if isinstance(x, DTensor):
        return moe_sharded(cfg, p, x)
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.top_k
    e_here = p["w1"].shape[0]
    cap = capacity(cfg, s)
    h = rmsnorm(x, p["norm"], cfg.norm_eps)
    _, topi, topv, arrival, keep = moe_route(cfg, p, h)
    if e_here < e:
        here = (topi >= first_expert) & (topi < first_expert + e_here)
        keep = keep & here
        topi = torch.where(here, topi - first_expert, 0)
    # each (token, choice) pair's slot in its expert's queue; a dropped pair
    # goes to a spare slot ``cap`` that no expert reads (no host sync)
    slot = torch.where(keep, arrival, cap)
    rows = torch.arange(b, device=h.device)[:, None, None].expand(b, s, k)
    xin = torch.zeros((e_here, b, cap + 1, d), dtype=h.dtype,
                      device=h.device)
    xin[topi, rows, slot] = h[:, :, None, :].expand(b, s, k, d)
    xin = xin[:, :, :cap].reshape(e_here, b * cap, d)
    hmid = silu(torch.bmm(xin, p["w1"])) * torch.bmm(xin, p["w3"])
    xout = torch.bmm(hmid, p["w2"]).reshape(e_here, b, cap, d)
    out = xout[topi, rows, slot.clamp(max=cap - 1)].float()   # (B, S, k, D)
    y = ((topv * keep)[..., None] * out).sum(dim=2)
    return y.to(x.dtype)


def moe_sharded(cfg: ModelConfig, p: Dict, x: torch.Tensor) -> torch.Tensor:
    """``moe_apply`` on a mesh. DTensor has no sharding strategy for the
    dispatch's ``index_put`` with tensor indices, so the layer runs on
    local shards through ``local_map``, its inputs redistributed
    explicitly: x batch-sharded as the residual stream is (``pin``),
    whole on ``model``; the router and norm replicated; the experts split
    over ``model`` by the ``experts`` rule, each whole in ``d_model`` (the
    FSDP shards are gathered). Every rank of the model axis routes all
    tokens of its batch shard, runs its own experts, and returns their
    share of each token's sum: ``Partial`` on ``model``, summed where the
    caller adds it to the residual. Where the experts do not split, every
    rank runs all of them and the output is replicated."""
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map
    from repro_torch.runtime import sharding as shd

    mesh = x.device_mesh
    names = list(shd.mesh_axes(mesh))
    batch = shd.placements(mesh, shd.spec_for(mesh, ("batch", None, None),
                                              x.shape))
    split = "model" in names and shd.resolve_dim(
        mesh, "experts", cfg.num_experts) == "model"
    experts = shd.placements(mesh, ("model",) if split else (None,))
    whole = [Replicate()] * len(names)
    out = list(batch)
    first = 0
    if split:
        out[names.index("model")] = Partial()
        first = mesh.get_local_rank("model") * \
            (cfg.num_experts // mesh.size(names.index("model")))
    keys = ("router", "w1", "w3", "w2", "norm")
    pls = (list(batch),) + tuple(
        list(experts) if k in ("w1", "w3", "w2") else whole for k in keys)

    def local(x, *ws):
        return moe_apply(cfg, dict(zip(keys, ws)), x, first)

    return local_map(local, out_placements=out, in_placements=pls,
                     in_grad_placements=shd.grad_placements(pls),
                     device_mesh=mesh, redistribute_inputs=True)(
        x, *(p[k] for k in keys))
