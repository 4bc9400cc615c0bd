"""The port's attention (plain versions, the K2 wrapper's CPU path and the
dispatch) against the reference.

The same inputs, made with numpy from a seed, go through the JAX package's
``attention_ref`` and ``attention_blockwise``, its Pallas kernel in
interpret mode (``flash_attention(..., interpret=True)``), and the port's
``attention_ref``, ``attention_blockwise`` and ``flash_attention`` (whose
CPU path is ``attention_ref``). Tolerances are those of
``tests/test_kernels.py``: float32 3e-5, bfloat16 2e-2.
"""

import functools

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as jflash
from repro_torch.kernels import flash_attention as K
from repro_torch.kernels import ops, ref

# tests/test_kernels.py:20-29
SWEEP = [(1, 4, 4, 128, 128, 64),     # MHA square
         (2, 8, 2, 128, 128, 64),     # GQA group 4
         (1, 8, 8, 64, 64, 128),      # wide head
         (1, 4, 1, 96, 96, 64),       # MQA, ragged seq
         (1, 8, 4, 1, 256, 64),       # decode: one query vs long KV
         (2, 4, 4, 37, 37, 32)]       # odd sizes


def tol_for(dtype):
    return dict(atol=2e-2, rtol=2e-2) if dtype == "bfloat16" \
        else dict(atol=3e-5, rtol=3e-5)


def _inputs(seed, b, hq, hkv, s, t, d, dtype="float32"):
    rng = np.random.default_rng(seed)
    npdt = ml_dtypes.bfloat16 if dtype == "bfloat16" else np.float32
    return tuple(rng.standard_normal(shape).astype(np.float32).astype(npdt)
                 for shape in ((b, hq, s, d), (b, hkv, t, d), (b, hkv, t, d)))


def _torch(a):
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("b,hq,hkv,s,t,d", SWEEP)
def test_plain_versions_match_reference(b, hq, hkv, s, t, d, causal, dtype):
    args = _inputs(b * 1000 + s + t, b, hq, hkv, s, t, d, dtype)
    jargs = [jnp.asarray(a) for a in args]
    targs = [_torch(a) for a in args]
    want = _np(jref.attention_ref(*jargs, causal=causal))
    want_blk = _np(jref.attention_blockwise(*jargs, causal=causal, block=64))
    got = ref.attention_ref(*targs, causal=causal)
    assert got.dtype == targs[0].dtype and tuple(got.shape) == (b, hq, s, d)
    np.testing.assert_allclose(_np(got), want, **tol_for(dtype))
    np.testing.assert_allclose(
        _np(ref.attention_blockwise(*targs, causal=causal, block=64)),
        want_blk, **tol_for(dtype))
    np.testing.assert_allclose(_np(K.flash_attention(*targs, causal=causal)),
                               want, **tol_for(dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,hq,hkv,s,t,d", [SWEEP[1], SWEEP[3], SWEEP[4],
                                            SWEEP[5]],
                         ids=["gqa", "ragged", "decode", "odd"])
def test_plain_version_matches_pallas_kernel(b, hq, hkv, s, t, d, dtype):
    """The reference's TPU kernel in interpret mode (jitted: it compiles
    once instead of dispatching every grid step), blocks of 64."""
    args = _inputs(7 + s, b, hq, hkv, s, t, d, dtype)
    fn = jax.jit(functools.partial(jflash, causal=True, interpret=True,
                                   block_q=64, block_k=64))
    want = _np(fn(*map(jnp.asarray, args)))
    got = K.flash_attention(*[_torch(a) for a in args], causal=True)
    np.testing.assert_allclose(_np(got), want, **tol_for(dtype))


def test_blockwise_block_invariance():
    targs = [_torch(a) for a in _inputs(3, 1, 4, 2, 160, 160, 64)]
    want = ref.attention_ref(*targs)
    for blk in (32, 64, 100, 160, 1024):
        np.testing.assert_allclose(
            _np(ref.attention_blockwise(*targs, block=blk)), _np(want),
            atol=2e-5, rtol=2e-5)


def test_fully_masked_rows_give_zero():
    """Causal with S > T: rows r < S - T see no key. The port's versions and
    the reference's kernel give 0 there; the reference's ``attention_ref``
    gives NaN (the difference the port's docstring states)."""
    args = _inputs(4, 1, 4, 2, 48, 16, 32)
    targs = [_torch(a) for a in args]
    for out in (ref.attention_ref(*targs), K.flash_attention(*targs),
                ref.attention_blockwise(*targs, block=8)):
        assert torch.equal(out[:, :, :32], torch.zeros_like(out[:, :, :32]))
        assert torch.isfinite(out).all() and out[:, :, 32:].abs().sum() > 0
    pallas = _np(jflash(*map(jnp.asarray, args), causal=True,
                        interpret=True, block_q=16, block_k=16))
    np.testing.assert_array_equal(pallas[:, :, :32], 0.0)
    np.testing.assert_allclose(_np(ref.attention_ref(*targs))[:, :, 32:],
                               pallas[:, :, 32:], atol=3e-5, rtol=3e-5)
    assert np.isnan(_np(jref.attention_ref(*map(jnp.asarray, args)))
                    [:, :, :32]).all()


def test_ops_dispatch_on_cpu(monkeypatch):
    """S * T > 1024 * 2048 streams kv blocks; below it one product."""
    calls = []
    monkeypatch.setattr(ref, "attention_ref",
                        lambda *a, **k: calls.append("ref") or a[0])
    monkeypatch.setattr(ref, "attention_blockwise",
                        lambda *a, **k: calls.append("blockwise") or a[0])
    q = torch.zeros((1, 1, 1024, 16))
    for t in (2048, 2049):
        ops.attention(q, torch.zeros((1, 1, t, 16)),
                      torch.zeros((1, 1, t, 16)))
    assert calls == ["ref", "blockwise"]


def test_ops_attention_matches_reference_blockwise_size():
    """At S = T = 1500 both packages take their blockwise path."""
    args = _inputs(5, 1, 2, 1, 1500, 1500, 16)
    want = _np(jops.attention(*map(jnp.asarray, args), causal=True))
    got = ops.attention(*[_torch(a) for a in args], causal=True)
    np.testing.assert_allclose(_np(got), want, atol=3e-5, rtol=3e-5)


def test_wrapper_on_cpu_takes_the_plain_version_and_counts_nothing(
        monkeypatch):
    calls = []
    real = ref.attention_ref
    monkeypatch.setattr(ref, "attention_ref",
                        lambda *a, **k: calls.append(k) or real(*a, **k))
    before = K.launches
    targs = [_torch(a) for a in _inputs(6, 2, 4, 2, 9, 9, 16)]
    K.flash_attention(*targs, causal=False, scale=0.5)
    assert K.launches == before
    assert calls == [dict(causal=False, scale=0.5)]


def test_default_scale_is_float32():
    for d in (16, 32, 64, 128):
        assert ref.default_scale(d) == float(np.float32(1.0 / np.sqrt(d)))


def test_cuda_tensor_never_takes_the_plain_path():
    """A non-CPU tensor launches the kernel or raises: ``meta`` tensors
    stand in for a device without the kernel."""
    args = [torch.empty(s, device="meta") for s in
            ((1, 4, 8, 16), (1, 2, 8, 16), (1, 2, 8, 16))]
    with pytest.raises(ValueError):
        K.flash_attention(*args)
    with pytest.raises(ValueError):
        ops.attention(*args)


def test_wrapper_rejects_bad_shapes():
    q, k, v = [_torch(a) for a in _inputs(8, 1, 6, 4, 8, 8, 16)]
    with pytest.raises(ValueError, match="multiple"):
        K.flash_attention(q, k, v)                  # Hq % Hkv != 0
    with pytest.raises(ValueError):
        K.flash_attention(q[..., :8], k, v)         # D differs
    with pytest.raises(ValueError):
        K.flash_attention(q[:, :4], k[:, :2], v[:, :1])
    with pytest.raises(ValueError):
        K.flash_attention(q[0], k[0], v[0])         # not 4-d
    with pytest.raises(ValueError):                 # on two devices
        K.flash_attention(q[:, :4], k[:, :2], v[:, :2].to("meta"))


def test_kernel_input_checks():
    """What the CUDA path takes: one dtype of float32 / bfloat16, D in
    {16, 32, 64, 128}, a contiguous d dimension; any other strides, so the
    model's (B, S, H, D) projections pass as (B, H, S, D) views."""
    x = torch.zeros((2, 10, 6, 64))                 # (B, S, H, D)
    q = x.transpose(1, 2)
    kv = torch.zeros((2, 10, 3, 64)).transpose(1, 2)
    assert K.kernel_strides(q, kv, kv) == (3840, 64, 384, 1920, 64, 192,
                                           1920, 64, 192)
    with pytest.raises(ValueError, match="dtype"):
        K.kernel_strides(q.half(), kv.half(), kv.half())
    with pytest.raises(ValueError, match="dtype"):
        K.kernel_strides(q, kv.bfloat16(), kv)
    with pytest.raises(ValueError, match="head dim"):
        K.kernel_strides(q[..., :48], kv[..., :48], kv[..., :48])
    with pytest.raises(ValueError, match="contiguous"):
        K.kernel_strides(q.transpose(2, 3).contiguous().transpose(2, 3),
                         kv, kv)
    with pytest.raises(ValueError, match="no keys"):
        K.kernel_strides(q, kv[:, :, :0], kv[:, :, :0])
    # bfloat16 goes through TMA: 16-byte-aligned bases, 16-byte strides
    qb, kvb = q.bfloat16(), kv.bfloat16()
    assert K.kernel_strides(qb, kvb, kvb) == K.kernel_strides(q, kv, kv)
    odd = torch.zeros((2, 10, 6, 66))[..., :64].transpose(1, 2)
    assert K.kernel_strides(odd, kv, kv)[:3] == (3960, 66, 396)
    with pytest.raises(ValueError, match="16-byte"):      # rows of 132 B
        K.kernel_strides(torch.zeros((2, 10, 6, 66), dtype=torch.bfloat16)
                         [..., :64].transpose(1, 2), kvb, kvb)
    shifted = torch.zeros(qb.numel() + 1, dtype=torch.bfloat16)[1:]
    shifted = shifted.view(2, 10, 6, 64).transpose(1, 2)     # base + 2 B
    with pytest.raises(ValueError, match="16-byte"):
        K.kernel_strides(shifted, kvb, kvb)
    with pytest.raises(ValueError, match="16-byte"):
        K.kernel_strides(qb, kvb, shifted[:, :3])


LOG2E = 1.4426950408889634


def _tensor_core_emulation(q, k, v, causal=True, bk=128):
    """The bf16 kernel's arithmetic in plain torch: 128-key tiles, logits
    scaled by the float32 ``scale * log2 e`` and exponentiated with exp2,
    masks as selects (-1e30, then p = 0), float32 m, l and accumulator, and
    P rounded to bfloat16 before P.V."""
    b, hq, hkv, g, s, t, d = ref.attention_dims(q, k, v)
    scale2 = float(np.float32(ref.default_scale(d)) * np.float32(LOG2E))
    qf = q.float().reshape(b, hkv, g, s, d)
    rows = torch.arange(s)[:, None]
    m = torch.full((b, hkv, g, s, 1), -1e30)
    l = torch.zeros((b, hkv, g, s, 1))
    acc = torch.zeros((b, hkv, g, s, d))
    for k0 in range(0, t, bk):
        kb, vb = k[:, :, k0:k0 + bk].float(), v[:, :, k0:k0 + bk].float()
        cols = k0 + torch.arange(kb.shape[2])[None, :]
        ok = cols <= rows + (t - s) if causal else \
            torch.ones((s, kb.shape[2]), dtype=torch.bool)
        x = torch.where(ok, torch.einsum("bhgsd,bhtd->bhgst", qf, kb) *
                        scale2, torch.full((), -1e30))
        mn = torch.maximum(m, x.amax(dim=-1, keepdim=True))
        p = torch.where(ok, torch.exp2(x - mn), torch.zeros(()))
        alpha = torch.exp2(m - mn)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.einsum("bhgst,bhtd->bhgsd",
                                         p.bfloat16().float(), vb)
        m = mn
    l = torch.where(l == 0, torch.ones(()), l)
    return (acc / l).reshape(b, hq, s, d).to(q.dtype)


@pytest.mark.parametrize("s,t", [(512, 512), (300, 200)],
                         ids=["square", "s_over_t"])
def test_tensor_core_arithmetic_within_bf16_tolerance(s, t):
    """The bf16 kernel rounds P to bfloat16 before P.V and works in the
    log2 domain: emulated in plain torch at D 128, causal, its output stays
    within the bf16 tolerance (2e-2 abs + rel) of ``attention_ref``, the
    fully-masked rows of S > T exactly 0."""
    targs = [_torch(a) for a in _inputs(11 + s, 1, 4, 2, s, t, 128,
                                        "bfloat16")]
    got = _tensor_core_emulation(*targs)
    want = ref.attention_ref(*targs)
    np.testing.assert_allclose(_np(got), _np(want), **tol_for("bfloat16"))
    if s > t:
        assert not got[:, :, :s - t].any()
    # the bf16 rounding of P is visible, and small against the tolerance
    exact = _tensor_core_emulation(*[x.float() for x in targs]).float()
    assert 0 < float((exact - want.float()).abs().max()) < 2e-2


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_head_dim_112_matches_reference(causal, dtype):
    """zamba2-7b's head dim 112 (the K2 wrapper takes it on the card; here
    its CPU path): held to the reference's Pallas kernel in interpret mode
    and to its XLA attention, at the tolerances of tests/test_kernels.py;
    the scale is 1/sqrt(112)."""
    b, hq, hkv, s, t, d = 1, 4, 2, 96, 96, 112
    args = _inputs(112 + causal, b, hq, hkv, s, t, d, dtype)
    jargs = [jnp.asarray(a) for a in args]
    targs = [_torch(a) for a in args]
    got = K.flash_attention(*targs, causal=causal)
    assert tuple(got.shape) == (b, hq, s, d) and got.dtype == targs[0].dtype
    fn = jax.jit(functools.partial(jflash, causal=causal, interpret=True,
                                   block_q=64, block_k=64))
    np.testing.assert_allclose(_np(got), _np(fn(*jargs)), **tol_for(dtype))
    np.testing.assert_allclose(_np(got), _np(jops.attention(
        *jargs, causal=causal)), **tol_for(dtype))
    assert ref.default_scale(d) == float(np.float32(1.0 / np.sqrt(112)))


def test_kernel_input_checks_take_head_dim_112():
    """The kernel takes D 112 in both dtypes (224-byte rows meet TMA's
    16-byte strides) and still rejects any other D outside HEAD_DIMS."""
    assert 112 in K.HEAD_DIMS
    x = torch.zeros((2, 10, 6, 112))
    q = x.transpose(1, 2)
    kv = torch.zeros((2, 10, 3, 112)).transpose(1, 2)
    want = (6720, 112, 672, 3360, 112, 336, 3360, 112, 336)
    assert K.kernel_strides(q, kv, kv) == want
    assert K.kernel_strides(q.bfloat16(), kv.bfloat16(), kv.bfloat16()) == \
        want
    for d in (48, 96, 120, 256):
        other = torch.zeros((1, 2, 8, d))
        with pytest.raises(ValueError, match="head dim"):
            K.kernel_strides(other, other, other)
