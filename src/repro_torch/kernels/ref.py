"""Plain PyTorch versions of the SSD scan and RMSNorm.

``ssd_ref`` is the sequential scan, the definition. ``ssd_chunked`` is the
same function in chunks -- dense masked products within a chunk, a short
loop over chunks for the carried state -- and is the plain version of the
hand-written kernel ``repro_torch.kernels.ssd_scan`` (K3). Both compute in
float32 and return ``x``'s dtype.

``ssd_chunked`` selects the intra-chunk decay with ``torch.where``: above
the diagonal ``A (cum_i - cum_j)`` is positive and its ``exp`` overflows
to ``inf`` once a chunk's summed ``dt`` passes about 88 / |A|; a mask that
multiplies (``inf * 0``) would turn that into NaN.
"""

from __future__ import annotations

import torch


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
        t = t.float()
        if pad:
            t = torch.cat([t, t.new_zeros((t.shape[0], pad) + t.shape[2:])],
                          dim=1)
        return t

    xf = pad_seq(x).reshape(bsz, nc, Lc, h, dh)
    dtf = pad_seq(dt).reshape(bsz, nc, Lc, h)
    Bf = pad_seq(B).reshape(bsz, nc, Lc, h, ds)
    Cf = pad_seq(C).reshape(bsz, nc, Lc, h, ds)
    Af = A.float()

    cum = torch.cumsum(dtf, dim=2)                       # (b, nc, Lc, h)
    cum_end = cum[:, :, -1:, :]                          # (b, nc, 1, h)
    # intra-chunk decay L(i,j) = exp(A (cum_i - cum_j)) for i >= j, else 0
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # (b,nc,i,j,h)
    tri = torch.ones((Lc, Lc), dtype=torch.bool, device=x.device).tril()
    Ldec = torch.where(tri[None, None, :, :, None], torch.exp(Af * diff),
                       torch.zeros((), device=x.device))
    cb = torch.einsum("bnihs,bnjhs->bnijh", Cf, Bf)
    w = cb * Ldec * dtf[:, :, None, :, :]
    y = torch.einsum("bnijh,bnjhd->bnihd", w, xf)

    # chunk-boundary states: S_n = sum_j exp(A(cum_end - cum_j)) dt_j B_j x_j
    sdec = torch.exp(Af * (cum_end - cum)) * dtf         # (b, nc, Lc, h)
    Sn = torch.einsum("bnjh,bnjhs,bnjhd->bnhsd", sdec, Bf, xf)
    gamma = torch.exp(Af * cum_end[:, :, 0, :])          # (b, nc, h)

    hprev = torch.zeros((bsz, h, ds, dh), dtype=torch.float32,
                        device=x.device)
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
