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
