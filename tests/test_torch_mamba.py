"""The port's Mamba-2 LM against the reference, on carried parameters.

The reference's ``LM(smoke).init(PRNGKey(7))`` parameters are carried into
the port (``import_lm_params``); forward logits, ``decode_step`` logits and
caches, and the serve loop's greedy tokens are compared with the JAX
package's. Two variants of the smoke config: float32 (tolerance 1e-4: the
two frameworks sum in different orders) and the model's bfloat16
(tolerance 5e-2, as ``tests/test_arch_smoke.py``: the frameworks round at
different places).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.kernels.ops as jops
from repro.configs import ARCHS as JARCHS
from repro.configs import get_config as jget_config
from repro.data.pipeline import SyntheticTokens as JSyntheticTokens
from repro.kernels import ref as jref
from repro.models.model import LM as JLM
from repro_torch.configs import ARCHS, get_config
from repro_torch.data.pipeline import SyntheticTokens
from repro_torch.launch import serve
from repro_torch.models.carry import import_lm_params
from repro_torch.models.model import LM

TOL = {"float32": dict(atol=1e-4, rtol=1e-4),
       "bfloat16": dict(atol=5e-2, rtol=5e-2)}


def _build(dtype):
    """(dtype, reference LM, its params, port LM with the same params)."""
    jcfg = jget_config("mamba2-370m").smoke().scaled(dtype=dtype)
    jm = JLM(jcfg)
    params = jm.init(jax.random.PRNGKey(7))
    cfg = get_config("mamba2-370m").smoke().scaled(dtype=dtype)
    m = import_lm_params(LM(cfg, device="cpu"),
                         jax.tree.map(np.asarray, params))
    return dtype, jm, params, m


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def pair(request):
    return _build(request.param)


@pytest.fixture(scope="module")
def pair32():
    return _build("float32")


def _tokens(seed, b, s, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)) \
        .astype(np.int32)


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("s", [16, 64])
def test_forward_matches_reference(pair, s):
    dtype, jm, params, m = pair
    toks = _tokens(s, 2, s, m.cfg.vocab)
    want = jax.jit(jm.forward)(params, dict(tokens=jnp.asarray(toks)))
    got = m.forward(dict(tokens=torch.from_numpy(toks)))
    assert got.dtype == {"float32": torch.float32,
                         "bfloat16": torch.bfloat16}[dtype]
    np.testing.assert_allclose(_np(got), _np(want), **TOL[dtype])


def test_forward_at_256_matches_sequential_reference(pair, monkeypatch):
    """At S=256 the reference's own CPU path (``ssd_chunked``) is NaN at
    these widths (fault 1), so the reference runs with its sequential
    ``ssd_ref`` in its place; the port's chunked path must be finite and
    match it."""
    dtype, jm, params, m = pair
    toks = _tokens(256, 1, 256, m.cfg.vocab)
    monkeypatch.setattr(jops, "ssd", lambda x, dt, A, B, C, **kw:
                        jref.ssd_ref(x, dt, A, B, C))
    want = jax.jit(jm.forward)(params, dict(tokens=jnp.asarray(toks)))
    got = m.forward(dict(tokens=torch.from_numpy(toks)))
    assert torch.isfinite(got.float()).all()
    np.testing.assert_allclose(_np(got), _np(want), **TOL[dtype])


def test_decode_steps_match_reference(pair):
    """8 decode steps: logits each step, then the whole cache."""
    dtype, jm, params, m = pair
    toks = _tokens(3, 2, 8, m.cfg.vocab)
    jcache = jm.init_cache(2, 8)
    cache = m.init_cache(2, 8)
    assert set(cache) == set(jcache)
    step = jax.jit(jm.decode_step)
    for t in range(8):
        want, jcache = step(params, jcache, jnp.asarray(toks[:, t:t + 1]))
        got, cache = m.decode_step(cache, torch.from_numpy(toks[:, t:t + 1]))
        np.testing.assert_allclose(_np(got), _np(want), **TOL[dtype])
    assert int(cache["pos"]) == int(jcache["pos"]) == 8
    for k in ("conv_x", "conv_B", "conv_C", "ssm"):
        assert tuple(cache[k].shape) == tuple(jcache[k].shape)
        np.testing.assert_allclose(_np(cache[k]), _np(jcache[k]),
                                   **TOL[dtype])


def test_decode_consistent_with_forward(pair):
    """The port's own teacher-forced decode against its forward, as
    ``tests/test_arch_smoke.py::test_decode_consistent_with_forward_ssm``."""
    dtype, _, _, m = pair
    toks = torch.from_numpy(_tokens(4, 1, 24, m.cfg.vocab))
    full = m.forward(dict(tokens=toks))
    cache = m.init_cache(1, 24)
    steps = [m.decode_step(cache, toks[:, t:t + 1])[0][:, 0]
             for t in range(24)]
    np.testing.assert_allclose(_np(torch.stack(steps, 1)), _np(full),
                               atol=5e-2, rtol=5e-2)


def test_prefill_returns_forward_and_leaves_cache(pair):
    dtype, jm, params, m = pair
    toks = _tokens(6, 2, 20, m.cfg.vocab)
    cache = m.init_cache(2, 32)
    logits, out = m.prefill(dict(tokens=torch.from_numpy(toks)), cache)
    jlogits, jout = jm.prefill(params, dict(tokens=jnp.asarray(toks)),
                               jm.init_cache(2, 32))
    np.testing.assert_allclose(_np(logits), _np(jlogits), **TOL[dtype])
    assert out is cache and int(out["pos"]) == int(jout["pos"]) == 0
    assert not out["ssm"].any()


def _jax_serve_loop(jm, params, prompt, new_tokens):
    """The greedy loop of ``repro.launch.serve.main``."""
    b, plen = prompt.shape
    cache = jm.init_cache(b, plen + new_tokens + 1)
    decode = jax.jit(jm.decode_step)
    for t in range(plen):
        logits, cache = decode(params, cache, prompt[:, t:t + 1])
    out = []
    cur = jnp.argmax(logits[:, -1:], axis=-1).astype(jnp.int32)
    for _ in range(new_tokens):
        out.append(cur)
        logits, cache = decode(params, cache, cur)
        cur = jnp.argmax(logits[:, -1:], axis=-1).astype(jnp.int32)
    return np.asarray(jnp.concatenate(out, axis=1))


def test_serve_loop_tokens_match_reference(pair32):
    """Greedy tokens are compared in float32: in bf16 the two frameworks
    round at other places and may flip a near-tie."""
    _, jm, params, m = pair32
    jbatch = JSyntheticTokens(jm.cfg, seq_len=6, global_batch=2).batch(0)
    batch = SyntheticTokens(m.cfg, seq_len=6, global_batch=2).batch(0)
    want = _jax_serve_loop(jm, params, jbatch["tokens"], 8)
    res = serve.generate(m, batch, 8)
    assert res.tokens.dtype == torch.int32
    np.testing.assert_array_equal(res.tokens.numpy(), want)


def test_serve_main_on_cpu(capsys):
    gen = serve.main(["--arch", "mamba2-370m", "--smoke", "--batch", "2",
                      "--prompt-len", "4", "--tokens", "3"], device="cpu")
    assert tuple(gen.shape) == (2, 3) and gen.dtype == torch.int32
    assert "tok/s" in capsys.readouterr().out


def test_lm_defaults_to_cuda_and_raises_without_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        LM(get_config("mamba2-370m").smoke())
    with pytest.raises(RuntimeError, match="cuda"):
        serve.main(["--smoke"])


def test_forward_calls_the_ssd_once_per_layer(monkeypatch):
    """Every layer's SSD goes through ``ops.ssd``, which hands a CUDA tensor
    to the kernel K3; the chip smoke run counts K3's launches there."""
    from repro_torch.kernels import ops
    calls = []
    real = ops.ssd
    monkeypatch.setattr(ops, "ssd",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    m = LM(get_config("mamba2-370m").smoke(), device="cpu")
    m.forward(dict(tokens=torch.from_numpy(_tokens(8, 1, 12, m.cfg.vocab))))
    assert len(calls) == m.cfg.layers


def test_import_checks_keys_shapes_and_dtypes():
    cfg = get_config("mamba2-370m").smoke()
    jcfg = jget_config("mamba2-370m").smoke()
    tree = jax.tree.map(np.asarray, JLM(jcfg).init(jax.random.PRNGKey(1)))
    m = import_lm_params(LM(cfg, device="cpu"), tree)
    np.testing.assert_array_equal(
        _np(m.mamba["in_x"]), np.asarray(tree["mamba"]["in_x"], np.float32))
    extra = dict(tree, other=dict(w=np.zeros(3)))
    with pytest.raises(KeyError):
        import_lm_params(LM(cfg, device="cpu"), extra)
    missing = dict(tree, mamba={k: v for k, v in tree["mamba"].items()
                                if k != "D"})
    with pytest.raises(KeyError):
        import_lm_params(LM(cfg, device="cpu"), missing)
    wrong = dict(tree, mamba=dict(tree["mamba"],
                                  D=tree["mamba"]["D"][:, :1]))
    with pytest.raises(ValueError):
        import_lm_params(LM(cfg, device="cpu"), wrong)
    f32 = dict(tree, embed=dict(tree["embed"], tok=tree["embed"]["tok"]
                                .astype(np.float32)))
    with pytest.raises(ValueError):
        import_lm_params(LM(cfg, device="cpu"), f32)


@pytest.mark.parametrize("arch", ["mamba2-370m", "llava-next-mistral-7b",
                                  "seamless-m4t-large-v2"])
def test_synthetic_tokens_match_reference(arch):
    cfg, jcfg = get_config(arch).smoke(), jget_config(arch).smoke()
    for step in (0, 5):
        got = SyntheticTokens(cfg, seq_len=33, global_batch=3,
                              seed=2).batch(step)
        want = JSyntheticTokens(jcfg, seq_len=33, global_batch=3,
                                seed=2).batch(step)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(),
                                          np.asarray(want[k]))
        assert got["tokens"].dtype == torch.int32


@pytest.mark.parametrize("arch", ["mamba2-370m", "zamba2-7b"])
def test_mamba_dims_match_reference(arch):
    from repro.models import mamba2 as JM
    from repro_torch.models import mamba2 as M

    for cfg, jcfg in ((get_config(arch), jget_config(arch)),
                      (get_config(arch).smoke(), jget_config(arch).smoke())):
        assert M._dims(cfg) == JM._dims(jcfg)
        assert M.conv_dim(cfg) == JM.conv_dim(jcfg)


def test_configs_equal_reference():
    assert ARCHS == JARCHS
    for arch in ARCHS:
        got, want = get_config(arch), jget_config(arch)
        assert dataclasses.asdict(got) == dataclasses.asdict(want), arch
        assert dataclasses.asdict(got.smoke()) == \
            dataclasses.asdict(want.smoke()), arch


def _param_count(cfg):
    d, di, hh, ds, k = cfg.d_model, cfg.d_inner, cfg.ssm_heads, \
        cfg.ssm_state, cfg.conv_kernel
    per_layer = (2 * d * di + 2 * d * hh * ds + d * hh + k * di
                 + 2 * k * hh * ds + 3 * hh + di * d + d + di)
    return per_layer, cfg.layers * per_layer + cfg.padded_vocab * d + d


def test_full_config_parameter_count():
    """Mamba-2 "370M" holds about 760M parameters here: every head has its
    own B and C, 14,756,960 parameters per layer, 48 layers, a 51.6M
    embedding. The count's formula is held to the port's smoke LM."""
    small = get_config("mamba2-370m").smoke()
    m = LM(small, device="cpu")
    assert _param_count(small)[1] == sum(p.numel() for p in m.parameters())
    per_layer, total = _param_count(get_config("mamba2-370m"))
    assert per_layer == 14_756_960
    assert total == 48 * 14_756_960 + 50_432 * 1024 + 1024
