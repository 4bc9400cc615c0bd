"""The port's SSD scan (plain versions and dispatch) against the reference.

The same inputs, made with numpy from a seed, go through the JAX package's
Pallas kernel in interpret mode (``ssd_scan(..., interpret=True)``), its
sequential oracle ``ref.ssd_ref``, and the port's plain versions
``ssd_ref`` and ``ssd_chunked`` (the CPU path of the kernel wrapper K3).
Tolerances are those of ``tests/test_kernels.py``: float32 3e-5, bfloat16
2e-2, chunk invariance 1e-4.
"""

import functools

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.ssd_scan import ssd_scan as jssd_scan
from repro_torch.kernels import ops, ref
from repro_torch.kernels import ssd_scan as K

SHAPES = [(1, 64, 2, 32, 16, 32),
          (2, 100, 4, 64, 32, 32),      # ragged: seq % chunk != 0
          (1, 256, 2, 64, 128, 128),
          (1, 32, 8, 128, 64, 16)]


def tol_for(dtype):
    return dict(atol=2e-2, rtol=2e-2) if dtype == "bfloat16" \
        else dict(atol=3e-5, rtol=3e-5)


def _inputs(seed, b, s, h, dh, ds, dtype="float32", dt_value=None, a=None):
    """x, dt, A, B, C as numpy (dtype as in the reference's sweep: x, dt, B,
    C in ``dtype``, A float32)."""
    rng = np.random.default_rng(seed)
    npdt = ml_dtypes.bfloat16 if dtype == "bfloat16" else np.float32
    x = rng.standard_normal((b, s, h, dh)).astype(np.float32)
    if dt_value is None:
        dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))) * 0.1
    else:
        dt = np.full((b, s, h), dt_value)
    A = -np.exp(rng.standard_normal(h)) if a is None else np.full(h, a)
    B = rng.standard_normal((b, s, h, ds))
    C = rng.standard_normal((b, s, h, ds))
    return (x.astype(npdt), dt.astype(npdt), A.astype(np.float32),
            B.astype(npdt), C.astype(npdt))


def _torch(a):
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _np(t):
    return t.float().numpy()


def _pallas(args, chunk):
    """The reference's Pallas kernel in interpret mode (jitted: it
    compiles once instead of dispatching every grid step)."""
    fn = jax.jit(functools.partial(jssd_scan, chunk=chunk, interpret=True))
    return np.asarray(fn(*map(jnp.asarray, args)), np.float32)


def _sequential(args):
    return np.asarray(jax.jit(jref.ssd_ref)(*map(jnp.asarray, args)),
                      np.float32)


@pytest.mark.parametrize("b,s,h,dh,ds,chunk", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_versions_match_reference(b, s, h, dh, ds, chunk, dtype):
    args = _inputs(b * 1000 + s, b, s, h, dh, ds, dtype)
    want_kernel = _pallas(args, chunk)
    want_seq = _sequential(args)
    targs = [_torch(a) for a in args]
    got_chunked = ref.ssd_chunked(*targs, chunk=chunk)
    got_seq = ref.ssd_ref(*targs)
    got_wrapper = K.ssd_scan(*targs, chunk=chunk)
    assert got_chunked.dtype == got_seq.dtype == targs[0].dtype
    for got in (got_chunked, got_seq, got_wrapper):
        np.testing.assert_allclose(_np(got), want_kernel, **tol_for(dtype))
        np.testing.assert_allclose(_np(got), want_seq, **tol_for(dtype))


def test_chunk_invariance():
    targs = [_torch(a) for a in _inputs(5, 1, 128, 2, 32, 16)]
    outs = [K.ssd_scan(*targs, chunk=c) for c in (16, 32, 64, 128)]
    for o in outs[1:]:
        np.testing.assert_allclose(_np(o), _np(outs[0]), atol=1e-4,
                                   rtol=1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_overflow_regime_is_finite(dtype):
    """dt = 2, A = -1, 256 steps in chunks of 128: above the diagonal
    A (cum_i - cum_j) reaches 254, whose exp is inf. The reference's
    ``ssd_chunked`` multiplies by the mask (``inf * 0 = NaN``); the port
    selects, as the Pallas kernel does, and matches the sequential scan."""
    args = _inputs(9, 1, 256, 2, 64, 16, dtype, dt_value=2.0, a=-1.0)
    want = _sequential(args)
    assert np.isfinite(want).all()
    # fault 1 of the reference, pinned: its chunked oracle is NaN here
    assert np.isnan(np.asarray(jref.ssd_chunked(*map(jnp.asarray, args),
                                                chunk=128), np.float32)).any()
    np.testing.assert_allclose(_pallas(args, 128), want, **tol_for(dtype))
    targs = [_torch(a) for a in args]
    for got in (ref.ssd_chunked(*targs, chunk=128), K.ssd_scan(*targs),
                ops.ssd(*targs)):
        assert torch.isfinite(got.float()).all()
        np.testing.assert_allclose(_np(got), want, **tol_for(dtype))


def test_ops_dispatch_on_cpu(monkeypatch):
    """seq > 16 takes the chunked version, seq <= 16 the sequential scan."""
    calls = []
    monkeypatch.setattr(ref, "ssd_chunked",
                        lambda *a, **k: calls.append("chunked") or a[0])
    monkeypatch.setattr(ref, "ssd_ref",
                        lambda *a, **k: calls.append("seq") or a[0])
    for s in (16, 17):
        ops.ssd(*[_torch(a) for a in _inputs(1, 1, s, 2, 8, 4)])
    assert calls == ["seq", "chunked"]


def test_ops_short_sequence_matches_reference():
    args = _inputs(3, 2, 9, 3, 16, 8)
    want = _sequential(args)
    np.testing.assert_allclose(_np(ops.ssd(*[_torch(a) for a in args])),
                               want, atol=3e-5, rtol=3e-5)


def test_cuda_tensor_never_takes_the_plain_path():
    """A non-CPU tensor launches the kernel or raises: ``meta`` tensors
    stand in for a device without the kernel."""
    args = [torch.empty(s, device="meta") for s in
            ((1, 32, 2, 8), (1, 32, 2), (2,), (1, 32, 2, 4), (1, 32, 2, 4))]
    with pytest.raises(ValueError):
        K.ssd_scan(*args)
    with pytest.raises(ValueError):
        ops.ssd(*args)


def test_wrapper_checks_shapes():
    x, dt, A, B, C = [_torch(a) for a in _inputs(2, 1, 20, 2, 8, 4)]
    with pytest.raises(ValueError):
        K.ssd_scan(x, dt[:, :10], A, B, C)
    with pytest.raises(ValueError):
        K.ssd_scan(x, dt, A, B, C[..., :2])


def test_rmsnorm_matches_reference():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((4, 8, 64)).astype(np.float32)
    w = (rng.random(64) + 0.5).astype(np.float32)
    want = np.asarray(jref.rmsnorm_ref(jnp.asarray(x), jnp.asarray(w)))
    got = ops.rmsnorm(torch.from_numpy(x), torch.from_numpy(w))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


def test_kernel_chunk():
    """The chunk K3 takes: the reference kernel's ``min(chunk, max(seq, 8))``."""
    assert K.chunk_of(2048) == 128 and K.chunk_of(100, 32) == 32
    assert K.chunk_of(5) == 8 and K.chunk_of(20) == 20


# ---- the bfloat16 kernel's arithmetic, emulated in plain torch -----------

SPLIT = ("W", "B o sdec", "h_in")   # the float32 operands the kernel splits


def _bf16_terms(v, split=True):
    """hi = bf16(v) and lo = bf16(v - hi), both back in float32; only hi
    where ``split`` is False (one rounding to bf16)."""
    hi = v.to(torch.bfloat16).float()
    return (hi, (v - hi).to(torch.bfloat16).float()) if split else (hi,)


def _kernel_emulation(x, dt, A, B, C, chunk=K.DEFAULT_CHUNK, split=SPLIT):
    """What the bfloat16 kernel (``ssd_tc``) computes, step for step, for
    bf16 x, B, C: per chunk of ``chunk_of(seq, chunk)`` steps (rows past the
    sequence zero, dt 0) the chunk-local G = C B^T (exact: bf16 products in
    float32), W = G o L o dt selected (never a multiplied mask), y_diag =
    W_hi x + W_lo x, S_c = (B o sdec)_hi^T x + (B o sdec)_lo^T x; then the
    chunk-by-chunk hand-off h_out = h_in exp(A cum_end) + S_c, and y = y_diag
    + exp(A cum_i) (C h_in,hi + C h_in,lo), rounded once to x's dtype. An
    operand left out of ``split`` is rounded to bf16 once instead. A test
    helper, on no path of the port."""
    bsz, seq, h, dh = x.shape
    ds = B.shape[-1]
    lc = K.chunk_of(seq, chunk)
    nc = -(-seq // lc)
    pad = nc * lc - seq

    def chunks(t):
        t = t.float()
        t = torch.cat([t, t.new_zeros((bsz, pad) + t.shape[2:])], dim=1)
        return t.reshape((bsz, nc, lc) + t.shape[2:]).movedim(3, 1)

    xs, Bs, Cs = chunks(x), chunks(B), chunks(C)     # (b, h, nc, lc, .)
    dts = chunks(dt)                                  # (b, h, nc, lc)
    a = A.float()[None, :, None, None]
    cum = torch.cumsum(dts, dim=-1)
    cend = cum[..., -1:]
    tri = torch.ones((lc, lc), dtype=torch.bool).tril()
    G = torch.einsum("bhnis,bhnjs->bhnij", Cs, Bs)
    Ldec = torch.where(tri, torch.exp(a[..., None] * (cum[..., :, None] -
                                                      cum[..., None, :])),
                       torch.zeros(()))
    W = torch.where(tri, G * Ldec * dts[..., None, :], torch.zeros(()))
    y = sum(torch.einsum("bhnij,bhnjd->bhnid", w, xs) for w in _bf16_terms(W, "W" in split))
    Bsd = Bs * (torch.exp(a * (cend - cum)) * dts)[..., None]
    S = sum(torch.einsum("bhnjs,bhnjd->bhnsd", v, xs)
            for v in _bf16_terms(Bsd, "B o sdec" in split))
    gend = torch.exp(a[..., 0] * cend[..., 0])       # (b, h, nc)
    hin = torch.zeros((bsz, h, ds, dh))
    for n in range(nc):
        if n:
            yoff = sum(torch.einsum("bhis,bhsd->bhid", Cs[:, :, n], v)
                       for v in _bf16_terms(hin, "h_in" in split))
            y[:, :, n] += torch.exp(a[..., 0, None] * cum[:, :, n, :, None]) \
                * yoff
        hin = hin * gend[:, :, n, None, None] + S[:, :, n]
    y = y.movedim(1, 3).reshape(bsz, nc * lc, h, dh)[:, :seq]
    return y.to(x.dtype)


@pytest.mark.parametrize("b,s,h,dh,ds,chunk", SHAPES)
def test_kernel_emulation_matches_reference(b, s, h, dh, ds, chunk):
    """The bf16 kernel's arithmetic against the Pallas kernel (interpret
    mode) and the sequential scan, on the same inputs as
    ``test_plain_versions_match_reference``; bf16 tolerance 2e-2."""
    args = _inputs(b * 1000 + s, b, s, h, dh, ds, "bfloat16")
    got = _np(_kernel_emulation(*[_torch(a) for a in args], chunk=chunk))
    np.testing.assert_allclose(got, _pallas(args, chunk), atol=2e-2,
                               rtol=2e-2)
    np.testing.assert_allclose(got, _sequential(args), atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("s,chunk", [(5, 128), (100, 8), (100, 16),
                                     (37, 128), (100, 37)])
def test_kernel_emulation_short_and_ragged_chunks(s, chunk):
    """Chunks of 8 (s = 5 takes 8), 16 and 37 steps, ragged tails, against
    the sequential scan; bf16 tolerance."""
    args = _inputs(s + chunk, 2, s, 3, 64, 32, "bfloat16")
    assert K.chunk_of(s, chunk) in (8, 16, 37)
    got = _kernel_emulation(*[_torch(a) for a in args], chunk=chunk)
    np.testing.assert_allclose(_np(got), _sequential(args), atol=2e-2,
                               rtol=2e-2)


def test_kernel_emulation_overflow_regime():
    """dt = 2, A = -1: W's decay is selected, so the output is finite and
    matches the sequential scan."""
    args = _inputs(9, 1, 256, 2, 64, 16, "bfloat16", dt_value=2.0, a=-1.0)
    got = _kernel_emulation(*[_torch(a) for a in args])
    assert torch.isfinite(got.float()).all()
    np.testing.assert_allclose(_np(got), _sequential(args), atol=2e-2,
                               rtol=2e-2)


@functools.lru_cache(maxsize=1)
def _prefill_chains():
    """Four prefill-shaped chains (s 2048, dh 64, ds 128, one batch row,
    four heads) and ``ssd_chunked`` on them."""
    args = [_torch(a) for a in _inputs(15, 1, 2048, 4, 64, 128, "bfloat16")]
    return args, ref.ssd_chunked(*args).float()


@pytest.mark.parametrize("unsplit", [None, *SPLIT])
def test_kernel_emulation_prefill_chain(unsplit):
    """Prefill-shaped chains (chunk 128) against ``ssd_chunked`` under the
    bf16 gate of 2e-2 abs + rel. With every float32 operand split into two
    bf16 terms, as the kernel does, every output is inside the gate; with
    any one of them rounded to bf16 once, some are not (which is why the
    kernel splits all three)."""
    args, want = _prefill_chains()
    split = tuple(s for s in SPLIT if s != unsplit)
    got = _kernel_emulation(*args, split=split).float()
    outside = int(((got - want).abs() > 2e-2 + 2e-2 * want.abs()).sum())
    assert (outside == 0) == (unsplit is None), outside
