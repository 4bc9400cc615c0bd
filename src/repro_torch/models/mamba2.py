"""Mamba-2 (SSD) block: projections -> depthwise causal conv -> SSD -> gate.

The port of ``repro.models.mamba2``. Prefill runs the chunked SSD (the
kernel K3 on the card); decode keeps an O(1) recurrent state per layer: the
SSM state h (heads, dstate, dhead) and the last (conv_kernel - 1) conv
inputs. As in the reference, x, B, C, z and dt have separate projections
and per-component depthwise convs, and every head has its own B and C.

Parameters are the reference's, stacked on a leading layers dim; the
functions below take one layer's slice (``{k: v[l]}``).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import _init, dtype_of, rmsnorm, silu


def _dims(cfg: ModelConfig) -> Tuple[int, int, int, int]:
    d_in = cfg.d_inner or 2 * cfg.d_model
    heads = cfg.ssm_heads or max(1, d_in // 64)
    dh = d_in // heads
    ds = cfg.ssm_state
    return d_in, heads, dh, ds


def conv_dim(cfg: ModelConfig) -> int:
    d_in, heads, dh, ds = _dims(cfg)
    return d_in + 2 * ds * heads


def mamba_init(cfg: ModelConfig, gen: torch.Generator,
               layers: int) -> Dict:
    d_in, heads, dh, ds = _dims(cfg)
    dt = dtype_of(cfg)
    dev = gen.device
    return dict(
        in_x=_init(gen, (layers, cfg.d_model, d_in), dtype=dt),
        in_B=_init(gen, (layers, cfg.d_model, heads * ds), dtype=dt),
        in_C=_init(gen, (layers, cfg.d_model, heads * ds), dtype=dt),
        in_z=_init(gen, (layers, cfg.d_model, d_in), dtype=dt),
        in_dt=_init(gen, (layers, cfg.d_model, heads), dtype=dt),
        conv_x=_init(gen, (layers, cfg.conv_kernel, d_in), scale=0.5,
                     dtype=dt),
        conv_B=_init(gen, (layers, cfg.conv_kernel, heads * ds), scale=0.5,
                     dtype=dt),
        conv_C=_init(gen, (layers, cfg.conv_kernel, heads * ds), scale=0.5,
                     dtype=dt),
        A_log=torch.zeros((layers, heads), dtype=torch.float32, device=dev),
        D=torch.ones((layers, heads), dtype=torch.float32, device=dev),
        dt_bias=torch.zeros((layers, heads), dtype=torch.float32, device=dev),
        out_proj=_init(gen, (layers, d_in, cfg.d_model), dtype=dt),
        norm=torch.ones((layers, cfg.d_model), dtype=dt, device=dev),
        gate_norm=torch.ones((layers, d_in), dtype=dt, device=dev),
    )


def _causal_conv(x: torch.Tensor, w: torch.Tensor, k: int) -> torch.Tensor:
    """Depthwise causal conv along seq: x (B, S, C), w (k, C)."""
    s = x.shape[1]
    pad = F.pad(x, (0, 0, k - 1, 0))
    out = pad[:, 0:s] * w[0]
    for i in range(1, k):
        out = out + pad[:, i:i + s] * w[i]
    return out


def mamba_apply(cfg: ModelConfig, p: Dict, x: torch.Tensor) -> torch.Tensor:
    """Full-sequence (prefill) forward. x: (B, S, D)."""
    d_in, heads, dh, ds = _dims(cfg)
    bsz, s, _ = x.shape
    h = rmsnorm(x, p["norm"], cfg.norm_eps)
    k = cfg.conv_kernel
    xs = silu(_causal_conv(h @ p["in_x"], p["conv_x"], k))
    B = silu(_causal_conv(h @ p["in_B"], p["conv_B"], k))
    C = silu(_causal_conv(h @ p["in_C"], p["conv_C"], k))
    z = h @ p["in_z"]
    dt = h @ p["in_dt"]
    xs = xs.reshape(bsz, s, heads, dh)
    B = B.reshape(bsz, s, heads, ds)
    C = C.reshape(bsz, s, heads, ds)
    dtv = F.softplus(dt.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    y = ops.ssd(xs, dtv, A, B, C)
    y = y + xs * p["D"].to(x.dtype)[None, None, :, None]
    y = y.reshape(bsz, s, d_in)
    y = y * silu(z)
    y = rmsnorm(y, p["gate_norm"], cfg.norm_eps)
    return (y @ p["out_proj"]).to(x.dtype)


def mamba_cache_init(cfg: ModelConfig, layers: int, batch: int, dtype,
                     device) -> Dict:
    d_in, heads, dh, ds = _dims(cfg)
    k = cfg.conv_kernel

    def zeros(shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=device)

    return dict(conv_x=zeros((layers, batch, k - 1, d_in)),
                conv_B=zeros((layers, batch, k - 1, heads * ds)),
                conv_C=zeros((layers, batch, k - 1, heads * ds)),
                ssm=zeros((layers, batch, heads, ds, dh), torch.float32))


def _conv_step(hist: torch.Tensor, new: torch.Tensor, w: torch.Tensor):
    """hist (B, k-1, C), new (B, C) -> (out (B, C), new hist)."""
    full = torch.cat([hist, new[:, None, :]], dim=1)
    out = torch.einsum("bkc,kc->bc", full, w)
    return out, full[:, 1:]


def mamba_step(cfg: ModelConfig, p: Dict, x: torch.Tensor, cache: Dict,
               ) -> Tuple[torch.Tensor, Dict]:
    """Single-token decode. x: (B, 1, D); cache slices are per-layer:
    conv_* (B, k-1, C), ssm (B, heads, ds, dh)."""
    d_in, heads, dh, ds = _dims(cfg)
    bsz = x.shape[0]
    h = rmsnorm(x, p["norm"], cfg.norm_eps)[:, 0]
    xr, hx = _conv_step(cache["conv_x"], h @ p["in_x"], p["conv_x"])
    Br, hB = _conv_step(cache["conv_B"], h @ p["in_B"], p["conv_B"])
    Cr, hC = _conv_step(cache["conv_C"], h @ p["in_C"], p["conv_C"])
    xs = silu(xr).reshape(bsz, heads, dh)
    B = silu(Br).reshape(bsz, heads, ds)
    C = silu(Cr).reshape(bsz, heads, ds)
    z = h @ p["in_z"]
    dt = h @ p["in_dt"]
    dtv = F.softplus(dt.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    decay = torch.exp(A[None] * dtv)
    hstate = cache["ssm"] * decay[..., None, None] + \
        torch.einsum("bh,bhs,bhd->bhsd", dtv, B.float(), xs.float())
    y = torch.einsum("bhs,bhsd->bhd", C.float(), hstate)
    y = y.to(x.dtype) + xs * p["D"].to(x.dtype)[None, :, None]
    y = y.reshape(bsz, d_in) * silu(z)
    y = rmsnorm(y, p["gate_norm"], cfg.norm_eps)
    return ((y @ p["out_proj"])[:, None, :]).to(x.dtype), \
        dict(conv_x=hx, conv_B=hB, conv_C=hC, ssm=hstate)
