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
from torch.distributed.tensor import DTensor

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.runtime import sharding as shd
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


def mamba_dims() -> Dict:
    return dict(in_x=("layers", "d_model", "d_inner"),
                in_B=("layers", "d_model", "bc_dim"),
                in_C=("layers", "d_model", "bc_dim"),
                in_z=("layers", "d_model", "d_inner"),
                in_dt=("layers", "d_model", "ssm_heads"),
                conv_x=("layers", None, "d_inner"),
                conv_B=("layers", None, "bc_dim"),
                conv_C=("layers", None, "bc_dim"),
                A_log=("layers", "ssm_heads"),
                D=("layers", "ssm_heads"),
                dt_bias=("layers", "ssm_heads"),
                out_proj=("layers", "d_inner", "d_model"),
                norm=("layers", None),
                gate_norm=("layers", "d_inner"))


def _channels(fn, x: DTensor, w: DTensor, *rest):
    """``fn(x, w, *rest)`` on local shards: a depthwise op, local in its
    channels, so every tensor keeps its own placements (x and its history
    batch-sharded, the channels of x, w and the history split alike by one
    rule) and the outputs take those of ``x`` and of the last input."""
    from torch.distributed.tensor.experimental import local_map

    ins = tuple(list(t.placements) for t in (x, w, *rest))
    outs = ins[0] if not rest else (ins[0], ins[-1])
    return local_map(fn, out_placements=outs, in_placements=ins,
                     in_grad_placements=shd.grad_placements(ins),
                     device_mesh=x.device_mesh,
                     redistribute_inputs=True)(x, w, *rest)


def _causal_conv(x: torch.Tensor, w: torch.Tensor, k: int) -> torch.Tensor:
    """Depthwise causal conv along seq: x (B, S, C), w (k, C). On a mesh it
    runs on local shards (``_channels``)."""
    if isinstance(x, DTensor):
        return _channels(lambda a, b: _causal_conv(a, b, k), x, w)
    s = x.shape[1]
    pad = F.pad(x, (0, 0, k - 1, 0))
    out = pad[:, 0:s] * w[0]
    for i in range(1, k):
        out = out + pad[:, i:i + s] * w[i]
    return out


def _heads_axis(mesh, bsz: int, heads: int) -> Dict:
    """Where the batch and the SSM heads split: the ``batch`` and
    ``ssm_heads`` rules, resolved once for every tensor of a block."""
    return dict(zip(("batch", "heads"),
                    shd.spec_for(mesh, ("batch", "ssm_heads"),
                                 (bsz, heads))))


def _ssd_block(cfg: ModelConfig, xs, B, C, dt, dt_bias, A_log, D, dtype):
    """The SSD of a block on its conv outputs: heads split out, ``dt``
    through softplus, the scan (K3 on the card), the ``D`` skip, heads
    merged: (B, S, d_in). On a mesh it runs on local shards through
    ``local_map``, batch on the data axes and heads on ``model`` (by the
    ``ssm_heads`` rule; the flat channel dims split with them, whole
    heads a rank): DTensor cannot split a channel dim into heads where a
    mesh axis cuts it mid-head (zamba2-7b's 56 heads on 16), and one
    local call keeps every reshape local. Where the heads do not split,
    every rank of the model axis runs all of them."""
    d_in, heads, dh, ds = _dims(cfg)
    bsz, s = xs.shape[:2]
    if isinstance(xs, DTensor):
        ch = ("batch", None, "heads")
        return shd.on_shards(
            lambda *a: _ssd_block(cfg, *a, dtype),
            (xs, B, C, dt, dt_bias, A_log, D),
            (ch, ch, ch, ch, ("heads",), ("heads",), ("heads",)), (ch,),
            _heads_axis(xs.device_mesh, bsz, heads))
    xs = xs.reshape(bsz, s, -1, dh)
    B = B.reshape(bsz, s, -1, ds)
    C = C.reshape(bsz, s, -1, ds)
    dtv = F.softplus(dt.float() + dt_bias)
    A = -torch.exp(A_log)
    y = ops.ssd(xs, dtv, A, B, C)
    y = y + xs * D.to(dtype)[None, None, :, None]
    return y.reshape(bsz, s, -1)


def mamba_apply(cfg: ModelConfig, p: Dict, x: torch.Tensor) -> torch.Tensor:
    """Full-sequence (prefill) forward. x: (B, S, D)."""
    h = rmsnorm(x, p["norm"], cfg.norm_eps)
    k = cfg.conv_kernel

    def proj(w, dim):
        """``h @ p[w]``, on a mesh constrained to its rule (the gradient
        too: ``sharding.constrain``)."""
        return shd.constrain(h @ p[w], ("batch", None, dim))

    xs = silu(_causal_conv(proj("in_x", "d_inner"), p["conv_x"], k))
    B = silu(_causal_conv(proj("in_B", "bc_dim"), p["conv_B"], k))
    C = silu(_causal_conv(proj("in_C", "bc_dim"), p["conv_C"], k))
    z = proj("in_z", "d_inner")
    dt = proj("in_dt", "ssm_heads")
    y = _ssd_block(cfg, xs, B, C, dt, p["dt_bias"], p["A_log"], p["D"],
                   x.dtype)
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
    """hist (B, k-1, C), new (B, C) -> (out (B, C), new hist). On a mesh it
    runs on local shards (``_channels``)."""
    if isinstance(new, DTensor):
        return _channels(lambda n, ww, hh: _conv_step(hh, n, ww), new, w,
                         hist)
    full = torch.cat([hist, new[:, None, :]], dim=1)
    out = torch.einsum("bkc,kc->bc", full, w)
    return out, full[:, 1:]


def _step_block(cfg: ModelConfig, xs, B, C, dt, dt_bias, A_log, D, state,
                dtype):
    """One token of the SSM on its conv outputs (B, channels): heads split
    out, the recurrence from ``state`` (B, heads, ds, dh), the ``D`` skip,
    heads merged: ``(y (B, d_in), new state)``. On a mesh, on local shards
    as ``_ssd_block``, placed as the ``ssm`` cache is."""
    d_in, heads, dh, ds = _dims(cfg)
    bsz = xs.shape[0]
    if isinstance(state, DTensor):
        ch = ("batch", "heads")
        return shd.on_shards(
            lambda *a: _step_block(cfg, *a, dtype),
            (xs, B, C, dt, dt_bias, A_log, D, state),
            (ch, ch, ch, ch, ("heads",), ("heads",), ("heads",),
             ch + (None, None)), (ch, ch + (None, None)),
            _heads_axis(state.device_mesh, bsz, heads))
    xs = xs.reshape(bsz, -1, dh)
    B = B.reshape(bsz, -1, ds)
    C = C.reshape(bsz, -1, ds)
    dtv = F.softplus(dt.float() + dt_bias)
    A = -torch.exp(A_log)
    decay = torch.exp(A[None] * dtv)
    hstate = state * decay[..., None, None] + \
        torch.einsum("bh,bhs,bhd->bhsd", dtv, B.float(), xs.float())
    y = torch.einsum("bhs,bhsd->bhd", C.float(), hstate)
    y = y.to(dtype) + xs * D.to(dtype)[None, :, None]
    return y.reshape(bsz, -1), hstate


def mamba_step(cfg: ModelConfig, p: Dict, x: torch.Tensor, cache: Dict,
               ) -> Tuple[torch.Tensor, Dict]:
    """Single-token decode. x: (B, 1, D); cache slices are per-layer:
    conv_* (B, k-1, C), ssm (B, heads, ds, dh)."""
    h = rmsnorm(x, p["norm"], cfg.norm_eps)[:, 0]

    def proj(w, dim):
        return shd.constrain(h @ p[w], ("batch", dim))

    xr, hx = _conv_step(cache["conv_x"], proj("in_x", "d_inner"),
                        p["conv_x"])
    Br, hB = _conv_step(cache["conv_B"], proj("in_B", "bc_dim"),
                        p["conv_B"])
    Cr, hC = _conv_step(cache["conv_C"], proj("in_C", "bc_dim"),
                        p["conv_C"])
    z = h @ p["in_z"]
    dt = proj("in_dt", "ssm_heads")
    y, hstate = _step_block(cfg, silu(xr), silu(Br), silu(Cr), dt,
                            p["dt_bias"], p["A_log"], p["D"], cache["ssm"],
                            x.dtype)
    y = y * silu(z)
    y = rmsnorm(y, p["gate_norm"], cfg.norm_eps)
    return ((y @ p["out_proj"])[:, None, :]).to(x.dtype), \
        dict(conv_x=hx, conv_B=hB, conv_C=hC, ssm=hstate)
