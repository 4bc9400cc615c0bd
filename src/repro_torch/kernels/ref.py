"""Plain PyTorch versions of attention, the SSD scan and RMSNorm.

``attention_ref`` is attention in one dense masked product, the plain
version of the hand-written kernel ``repro_torch.kernels.flash_attention``
(K2); ``attention_blockwise`` is the same function over kv blocks with an
online softmax, the reference's XLA path for long sequences. Layout
``(B, H, S, D)`` for q and ``(B, Hkv, T, D)`` for k and v; q head
``j * g + i`` (g = Hq / Hkv) reads kv head ``j``; with ``causal`` query row
``r`` sees key columns ``c <= r + (T - S)``. Float32 inside, the output in
q's dtype. Two differences from the reference's versions, both where the
reference is not what its kernel computes:

- a fully-masked row (causal with S > T) gives 0 in both, as the kernel
  does; the reference's ``attention_ref`` gives NaN there (softmax of all
  ``-inf``) and its ``attention_blockwise`` the mean of v over its block;
- the default scale is the float32 ``1/sqrt(D)`` in both, as in the
  kernel; the reference's ``attention_ref`` rounds it to q's dtype
  (1.1e-4 relative in bfloat16 at D = 128).

``ssd_ref`` is the sequential scan, the definition. ``ssd_chunked`` is the
same function in chunks -- dense masked products within a chunk, a short
loop over chunks for the carried state -- and is the plain version of the
hand-written kernel ``repro_torch.kernels.ssd_scan`` (K3). Both compute in
float32 and return ``x``'s dtype.

``ssd_chunked`` masks the intra-chunk decay's exponent before the ``exp``:
above the diagonal ``A (cum_i - cum_j)`` is positive, and its ``exp``
overflows to ``inf`` once a chunk's summed ``dt`` passes about 88 / |A|.
A mask that multiplies (``inf * 0``) turns that into NaN in the forward;
a select after the ``exp`` keeps the forward finite but not the backward,
which multiplies the masked zero gradient by ``exp``'s ``inf``. The
exponent is set to ``-inf`` there, so ``exp`` gives exactly the 0 the
select gave and no ``inf`` enters the graph.

``attention_ref`` and ``ssd_chunked`` are the backward of the kernels on
the card (``repro_torch.kernels.grad``). They compute in float32, or in
float64 for float64 inputs (``wide``), so that the gradient check in
float64 can run through them.
"""

from __future__ import annotations

from typing import Optional

import torch

_NEG = -1e30              # the masked logit of the blockwise version


def attention_dims(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """(B, Hq, Hkv, g, S, T, D) of an attention call; raises on shapes that
    do not fit."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape or \
            q.shape[0] != k.shape[0] or q.shape[3] != k.shape[3]:
        raise ValueError(f"q must be (B, Hq, S, D) and k, v (B, Hkv, T, D); "
                         f"got q {tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)}")
    b, hq, s, d = q.shape
    hkv, t = k.shape[1], k.shape[2]
    if hkv == 0 or hq % hkv:
        raise ValueError(f"Hq = {hq} is not a multiple of Hkv = {hkv}")
    return b, hq, hkv, hq // hkv, s, t, d


def wide(t: torch.Tensor) -> torch.Tensor:
    """``t`` in float32, or as it is if float64."""
    return t if t.dtype == torch.float64 else t.float()


def default_scale(d: int) -> float:
    """The float32 ``1/sqrt(D)`` of the kernel and of both plain versions."""
    return float(torch.tensor(1.0 / d ** 0.5, dtype=torch.float32))


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True,
                  scale: Optional[float] = None) -> torch.Tensor:
    """Attention in one masked product (module docstring). Returns
    (B, Hq, S, D) in q's dtype; a fully-masked row is 0."""
    b, hq, hkv, g, s, t, d = attention_dims(q, k, v)
    scale = default_scale(d) if scale is None else scale
    qf = wide(q).reshape(b, hkv, g, s, d)
    logits = torch.einsum("bhgsd,bhtd->bhgst", qf, wide(k)) * scale
    if causal:
        mask = torch.ones((s, t), dtype=torch.bool,
                          device=q.device).tril(t - s)
        logits = torch.where(mask, logits,
                             torch.full((), float("-inf"), device=q.device))
    m = logits.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros((), device=q.device))
    p = torch.exp(logits - m)                  # exp(-inf) = 0 where masked
    denom = p.sum(dim=-1, keepdim=True)
    denom = torch.where(denom == 0, torch.ones((), device=q.device), denom)
    out = torch.einsum("bhgst,bhtd->bhgsd", p, wide(v)) / denom
    return out.reshape(b, hq, s, d).to(q.dtype)


def attention_blockwise(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, scale: Optional[float] = None,
                        block: int = 1024) -> torch.Tensor:
    """The same function over kv blocks of ``block`` columns with an online
    softmax (running max m, running sum l, ``l == 0 -> 1`` at the end), so
    that no (S, T) product is held whole. Masked logits are ``-1e30`` and
    their weights are selected to 0."""
    b, hq, hkv, g, s, t, d = attention_dims(q, k, v)
    scale = default_scale(d) if scale is None else scale
    blk = min(block, t)
    qf = q.float().reshape(b, hkv, g, s, d)
    rows = torch.arange(s, device=q.device)[:, None]
    zero = torch.zeros((), device=q.device)
    m = torch.full((b, hkv, g, s, 1), _NEG, device=q.device)
    l = torch.zeros((b, hkv, g, s, 1), device=q.device)
    acc = torch.zeros((b, hkv, g, s, d), device=q.device)
    for c0 in range(0, t, blk):
        kb, vb = k[:, :, c0:c0 + blk].float(), v[:, :, c0:c0 + blk].float()
        logits = torch.einsum("bhgsd,bhtd->bhgst", qf, kb) * scale
        cols = c0 + torch.arange(kb.shape[2], device=q.device)[None, :]
        mask = (cols <= rows + (t - s)) if causal else \
            torch.ones((s, kb.shape[2]), dtype=torch.bool, device=q.device)
        logits = torch.where(mask, logits, torch.full((), _NEG,
                                                      device=q.device))
        m_new = torch.maximum(m, logits.amax(dim=-1, keepdim=True))
        p = torch.where(mask, torch.exp(logits - m_new), zero)
        alpha = torch.exp(m - m_new)
        l = alpha * l + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.einsum("bhgst,bhtd->bhgsd", p, vb)
        m = m_new
    l = torch.where(l == 0, torch.ones((), device=q.device), l)
    return (acc / l).reshape(b, hq, s, d).to(q.dtype)


def ssd_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
            B: torch.Tensor, C: torch.Tensor) -> torch.Tensor:
    """Mamba-2 SSD (state-space duality) reference: sequential scan.

    Shapes: x (batch, seq, heads, dhead), dt (batch, seq, heads),
    A (heads,) [negative decay], B/C (batch, seq, heads, dstate).
    Returns y (batch, seq, heads, dhead).

    Recurrence per head: h_t = exp(A*dt_t) * h_{t-1} + dt_t * B_t x_t^T;
    y_t = C_t^T h_t  (h: (dstate, dhead)).
    """
    bsz, seq, h, dh = x.shape
    ds = B.shape[-1]
    xf, dtf, Bf, Cf = x.float(), dt.float(), B.float(), C.float()
    Af = A.float()
    hstate = torch.zeros((bsz, h, ds, dh), dtype=torch.float32,
                         device=x.device)
    ys = []
    for t in range(seq):
        dtt = dtf[:, t]                                    # (b, h)
        decay = torch.exp(Af[None, :] * dtt)[..., None, None]
        hstate = hstate * decay + torch.einsum(
            "bh,bhs,bhd->bhsd", dtt, Bf[:, t], xf[:, t])
        ys.append(torch.einsum("bhs,bhsd->bhd", Cf[:, t], hstate))
    return torch.stack(ys, dim=1).to(x.dtype)


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                B: torch.Tensor, C: torch.Tensor,
                chunk: int = 128) -> torch.Tensor:
    """Chunked SSD: dense masked products within chunks of ``min(chunk,
    seq)`` steps, a loop over chunks for the state; steps past ``seq`` are
    zero padding (``dt = 0``)."""
    bsz, seq, h, dh = x.shape
    ds = B.shape[-1]
    Lc = min(chunk, seq)
    nc = -(-seq // Lc)
    pad = nc * Lc - seq

    def pad_seq(t):
        t = wide(t)
        if pad:
            t = torch.cat([t, t.new_zeros((t.shape[0], pad) + t.shape[2:])],
                          dim=1)
        return t

    xf = pad_seq(x).reshape(bsz, nc, Lc, h, dh)
    dtf = pad_seq(dt).reshape(bsz, nc, Lc, h)
    Bf = pad_seq(B).reshape(bsz, nc, Lc, h, ds)
    Cf = pad_seq(C).reshape(bsz, nc, Lc, h, ds)
    Af = wide(A)

    cum = torch.cumsum(dtf, dim=2)                       # (b, nc, Lc, h)
    cum_end = cum[:, :, -1:, :]                          # (b, nc, 1, h)
    # intra-chunk decay L(i,j) = exp(A (cum_i - cum_j)) for i >= j, else 0;
    # the exponent is masked to -inf before the exp (module docstring)
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # (b,nc,i,j,h)
    tri = torch.ones((Lc, Lc), dtype=torch.bool, device=x.device).tril()
    Ldec = torch.exp(torch.where(tri[None, None, :, :, None], Af * diff,
                                 torch.full((), float("-inf"),
                                            device=x.device)))
    cb = torch.einsum("bnihs,bnjhs->bnijh", Cf, Bf)
    w = cb * Ldec * dtf[:, :, None, :, :]
    y = torch.einsum("bnijh,bnjhd->bnihd", w, xf)

    # The other three exps cannot overflow: A <= 0 and dt >= 0 (the models
    # pass A = -exp(A_log) and dt = softplus(...)), so cum is non-decreasing
    # within a chunk and each exponent below is <= 0.
    # chunk-boundary states: S_n = sum_j exp(A(cum_end - cum_j)) dt_j B_j x_j
    sdec = torch.exp(Af * (cum_end - cum)) * dtf         # (b, nc, Lc, h)
    Sn = torch.einsum("bnjh,bnjhs,bnjhd->bnhsd", sdec, Bf, xf)
    gamma = torch.exp(Af * cum_end[:, :, 0, :])          # (b, nc, h)

    hprev = xf.new_zeros((bsz, h, ds, dh))
    hins = []                                            # state entering chunk
    for n in range(nc):
        hins.append(hprev)
        hprev = hprev * gamma[:, n, :, None, None] + Sn[:, n]
    hins = torch.stack(hins, dim=1)                      # (b, nc, h, ds, dh)
    y = y + torch.einsum("bnihs,bnhsd->bnihd",
                         Cf * torch.exp(Af * cum)[..., None], hins)
    y = y.reshape(bsz, nc * Lc, h, dh)[:, :seq]
    return y.to(x.dtype)


def rmsnorm_ref(x: torch.Tensor, w: torch.Tensor,
                eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * w.float()).to(x.dtype)
