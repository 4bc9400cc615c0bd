"""The port's dense LM (``llama3.2-3b`` smoke) against the reference, on
carried parameters.

The reference's ``LM(smoke).init(PRNGKey(7))`` parameters are carried into
the port (``import_lm_params``), with ``tp_pad=1`` and with ``tp_pad=16``
(the full config's layout: kv heads replicated to 16, zero-weighted dummy
q slots, as ``tests/test_tp_padding.py``). Forward logits, ``decode_step``
logits and k/v caches, the prefill's cache and the serve loop's greedy
tokens are compared with the JAX package's: float32 within 1e-4 (the two
frameworks sum in different orders) and the model's bfloat16 within 5e-2
(as ``tests/test_arch_smoke.py``: the frameworks round at other places).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.launch.serve as jserve
from repro.configs import get_config as jget_config
from repro.models import layers as JL
from repro.models.model import LM as JLM
from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.launch import serve
from repro_torch.models import layers as L
from repro_torch.models.carry import import_lm_params
from repro_torch.models.model import LM

ARCH = "llama3.2-3b"
TOL = {"float32": dict(atol=1e-4, rtol=1e-4),
       "bfloat16": dict(atol=5e-2, rtol=5e-2)}


def _cfgs(dtype, tp_pad):
    return (get_config(ARCH).smoke().scaled(dtype=dtype, tp_pad=tp_pad),
            jget_config(ARCH).smoke().scaled(dtype=dtype, tp_pad=tp_pad))


def _carried(cfg, jcfg, key=7):
    """(reference LM, its params, port LM on the CPU with the same)."""
    jm = JLM(jcfg)
    params = jm.init(jax.random.PRNGKey(key))
    m = import_lm_params(LM(cfg, device="cpu"),
                         jax.tree.map(np.asarray, params))
    return jm, params, m


@pytest.fixture(scope="module",
                params=[("float32", 1), ("float32", 16), ("bfloat16", 1),
                        ("bfloat16", 16)],
                ids=["f32-tp1", "f32-tp16", "bf16-tp1", "bf16-tp16"])
def pair(request):
    dtype, tp_pad = request.param
    return (dtype,) + _carried(*_cfgs(dtype, tp_pad))


def _tokens(seed, b, s, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)) \
        .astype(np.int32)


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      jnp.asarray(x, jnp.float32))


def _teacher_forced(jm, params, toks, max_seq):
    """The reference's cache after teacher-forcing ``toks`` through its
    ``decode_step`` (how its serve loop fills a cache), and the logits."""
    jcache = jm.init_cache(toks.shape[0], max_seq)
    step = jax.jit(jm.decode_step)
    logits = []
    for t in range(toks.shape[1]):
        lg, jcache = step(params, jcache, jnp.asarray(toks[:, t:t + 1]))
        logits.append(lg)
    return jcache, logits


@pytest.mark.parametrize("s", [16, 64])
def test_forward_matches_reference(pair, s):
    dtype, jm, params, m = pair
    toks = _tokens(s, 2, s, m.cfg.vocab)
    want = jax.jit(jm.forward)(params, dict(tokens=jnp.asarray(toks)))
    got = m.forward(dict(tokens=torch.from_numpy(toks)))
    assert got.dtype == {"float32": torch.float32,
                         "bfloat16": torch.bfloat16}[dtype]
    np.testing.assert_allclose(_np(got), _np(want), **TOL[dtype])


def test_forward_on_the_blockwise_path_matches_reference():
    """S = 1500: S * S > 1024 * 2048, so both packages' CPU attention streams
    kv blocks (``attention_blockwise``)."""
    jm, params, m = _carried(*_cfgs("float32", 1))
    toks = _tokens(1500, 1, 1500, m.cfg.vocab)
    want = jax.jit(jm.forward)(params, dict(tokens=jnp.asarray(toks)))
    got = m.forward(dict(tokens=torch.from_numpy(toks)))
    np.testing.assert_allclose(_np(got), _np(want), **TOL["float32"])


def test_decode_steps_match_reference(pair):
    """6 decode steps: logits each step, then the whole k/v cache."""
    dtype, jm, params, m = pair
    toks = _tokens(3, 2, 6, m.cfg.vocab)
    jcache, jlogits = _teacher_forced(jm, params, toks, 8)
    cache = m.init_cache(2, 8)
    assert set(cache) == set(jcache)
    for t in range(6):
        got, cache = m.decode_step(cache, torch.from_numpy(toks[:, t:t + 1]))
        np.testing.assert_allclose(_np(got), _np(jlogits[t]), **TOL[dtype])
    assert int(cache["pos"]) == int(jcache["pos"]) == 6
    for k in ("k", "v"):
        assert tuple(cache[k].shape) == tuple(jcache[k].shape)
        np.testing.assert_allclose(_np(cache[k]), _np(jcache[k]),
                                   **TOL[dtype])


def test_prefill_cache_matches_teacher_forced_reference(pair):
    """The port's prefill writes k and v in the same pass as the logits; the
    cache equals the reference's teacher-forced one (fault 4: the
    reference's own prefill leaves it at zero)."""
    dtype, jm, params, m = pair
    toks = _tokens(5, 2, 7, m.cfg.vocab)
    jcache, _ = _teacher_forced(jm, params, toks, 10)
    cache = m.init_cache(2, 10)
    logits, out = m.prefill(dict(tokens=torch.from_numpy(toks)), cache)
    assert out is cache and int(cache["pos"]) == int(jcache["pos"]) == 7
    for k in ("k", "v"):
        np.testing.assert_allclose(_np(cache[k]), _np(jcache[k]),
                                   **TOL[dtype])
        assert not cache[k][:, :, :, 7:].any()
    want = jax.jit(jm.forward)(params, dict(tokens=jnp.asarray(toks)))
    np.testing.assert_allclose(_np(logits), _np(want), **TOL[dtype])


def test_decode_after_prefill_matches_forward(pair):
    dtype, jm, params, m = pair
    toks = _tokens(6, 2, 9, m.cfg.vocab)
    cache = m.init_cache(2, 12)
    m.prefill(dict(tokens=torch.from_numpy(toks[:, :8])), cache)
    got, cache = m.decode_step(cache, torch.from_numpy(toks[:, 8:]))
    want = jax.jit(jm.forward)(params, dict(tokens=jnp.asarray(toks)))
    np.testing.assert_allclose(_np(got[:, 0]), _np(want[:, 8]), **TOL[dtype])
    assert int(cache["pos"]) == 9


def test_reference_prefill_leaves_kv_at_zero():
    """Fault 4 of the reference, pinned: its dense ``prefill`` sets ``pos``
    to the prompt length and never writes k or v, so a decode after it
    attends to zeros."""
    jm, params, m = _carried(*_cfgs("float32", 1))
    toks = _tokens(9, 2, 8, m.cfg.vocab)
    _, jout = jm.prefill(params, dict(tokens=jnp.asarray(toks)),
                         jm.init_cache(2, 10))
    assert int(jout["pos"]) == 8
    assert float(jnp.abs(jout["k"]).max()) == 0.0
    assert float(jnp.abs(jout["v"]).max()) == 0.0
    cache = m.init_cache(2, 10)
    m.prefill(dict(tokens=torch.from_numpy(toks)), cache)
    assert float(cache["k"].abs().max()) > 0.1


def test_reference_init_makes_attention_a_hard_max(monkeypatch):
    """Fault 5 of the reference, pinned: its ``_init`` scales a draw by
    ``1/sqrt(shape[-2])``, which for the 4-d (layers, d_model, heads, hd)
    q/k/v draws is ``1/sqrt(heads)``, not the fan-in ``1/sqrt(d_model)``.
    With d_model 512 and 4 heads the largest layer-0 attention logit of
    the reference's weights is about 950, of the port's own fan-in init
    about 5. At llama3.2-3b (d_model 3072, 24 heads) the reference's q and
    k are 11.3 times too large, its logits 128 times, and its attention a
    hard max."""
    cfg = get_config(ARCH).scaled(layers=1, d_model=512, heads=4,
                                  kv_heads=2, head_dim=64, d_ff=128,
                                  vocab=256, tp_pad=1, dtype="float32")
    jcfg = jget_config(ARCH).scaled(**{k: getattr(cfg, k) for k in (
        "layers", "d_model", "heads", "kv_heads", "head_dim", "d_ff",
        "vocab", "tp_pad", "dtype")})
    jparams = JLM(jcfg).init(jax.random.PRNGKey(0))
    np.testing.assert_allclose(np.std(np.asarray(jparams["attn"]["wq"])),
                               4 ** -0.5, rtol=0.05)
    own = LM(cfg, device="cpu")
    np.testing.assert_allclose(float(own.attn["wq"].std()), 512 ** -0.5,
                               rtol=0.05)
    carried = import_lm_params(LM(cfg, device="cpu"),
                               jax.tree.map(np.asarray, jparams))
    peak = []
    real = ops.attention

    def spy(q, k, v, causal=True):
        g = q.shape[1] // k.shape[1]
        lg = torch.einsum("bhsd,bhtd->bhst", q,
                          k.repeat_interleave(g, 1)) * q.shape[-1] ** -0.5
        peak.append(float(lg.abs().max()))
        return real(q, k, v, causal=causal)
    monkeypatch.setattr(ops, "attention", spy)
    toks = torch.from_numpy(_tokens(12, 1, 64, cfg.vocab))
    own.forward(dict(tokens=toks))
    carried.forward(dict(tokens=toks))
    assert peak[1] > 100 * peak[0] and peak[0] < 10


def test_serve_main_tokens_match_reference(monkeypatch, capsys):
    """Both ``serve.main`` at ``--smoke`` with the same weights (the
    reference's ``PRNGKey(0)`` init, carried) in float32: the same greedy
    tokens. In bfloat16 the frameworks round at other places and may flip
    a near-tie."""
    cfg, jcfg = _cfgs("float32", 1)
    jparams = jax.tree.map(np.asarray,
                           JLM(jcfg).init(jax.random.PRNGKey(0)))
    monkeypatch.setattr(jserve, "get_config",
                        lambda a: jget_config(a).scaled(dtype="float32"))
    monkeypatch.setattr(serve, "get_config",
                        lambda a: get_config(a).scaled(dtype="float32"))
    monkeypatch.setattr(serve, "LM", lambda c, device, seed: import_lm_params(
        LM(c, device=device, seed=seed), jparams))
    argv = ["--arch", ARCH, "--smoke", "--batch", "2", "--prompt-len", "6",
            "--tokens", "8"]
    want = np.asarray(jserve.main(argv))
    got = serve.main(argv, device="cpu")
    assert got.dtype == torch.int32 and tuple(got.shape) == (2, 8)
    np.testing.assert_array_equal(got.numpy(), want)


def test_serve_main_bf16_on_cpu(capsys):
    gen = serve.main(["--arch", ARCH, "--smoke", "--batch", "2",
                      "--prompt-len", "5", "--tokens", "4"], device="cpu")
    assert tuple(gen.shape) == (2, 4) and gen.dtype == torch.int32
    assert "tok/s" in capsys.readouterr().out


def test_attention_goes_through_ops_once_per_layer(monkeypatch):
    """Every layer's prefill attention goes through ``ops.attention``, which
    hands a CUDA tensor to K2 (the chip smoke run counts K2's launches
    there); decode takes the plain masked attention, as the reference."""
    calls = []
    real = ops.attention
    monkeypatch.setattr(ops, "attention",
                        lambda *a, **k: calls.append(a[0].shape) or
                        real(*a, **k))
    cfg = get_config(ARCH).smoke()
    m = LM(cfg, device="cpu")
    toks = torch.from_numpy(_tokens(8, 2, 12, cfg.vocab))
    cache = m.init_cache(2, 16)
    m.prefill(dict(tokens=toks), cache)
    assert calls == [(2, 4, 12, 16)] * cfg.layers
    m.decode_step(cache, toks[:, :1])
    assert len(calls) == cfg.layers


def test_decode_writes_the_cache_at_pos_without_host_sync(monkeypatch):
    """The decode cache write takes ``pos`` as a device index: no ``.item()``
    (a host sync per layer) on the way."""
    cfg = get_config(ARCH).smoke().scaled(dtype="float32")
    m = LM(cfg, device="cpu")
    cache = m.init_cache(1, 6)
    toks = torch.from_numpy(_tokens(10, 1, 3, cfg.vocab))

    def no_item(self):
        raise AssertionError("decode_step read a tensor on the host")
    monkeypatch.setattr(torch.Tensor, "item", no_item)
    for t in range(3):
        m.decode_step(cache, toks[:, t:t + 1])
    monkeypatch.undo()
    assert int(cache["pos"]) == 3
    assert cache["k"][:, :, :, :3].abs().amax(dim=(0, 1, 2, 4)).min() > 0
    assert not cache["k"][:, :, :, 3:].any()


@pytest.mark.parametrize("tp_pad", [1, 16])
def test_padded_heads_and_maps_match_reference(tp_pad):
    from repro.configs import ARCHS
    for arch in ARCHS:
        cfg = get_config(arch).scaled(tp_pad=tp_pad)
        jcfg = jget_config(arch).scaled(tp_pad=tp_pad)
        assert L.padded_heads(cfg) == JL.padded_heads(jcfg), arch
        if cfg.heads:
            for a, b in zip(L._head_maps(cfg), JL._head_maps(jcfg)):
                np.testing.assert_array_equal(a, b)


def test_carried_tp16_layout():
    """The carried ``tp_pad=16`` tree: 16 kv heads (each original one twice),
    16 q slots of which the dummies are zero in wq and wo."""
    cfg, jcfg = _cfgs("float32", 16)
    _, params, m = _carried(cfg, jcfg)
    hq_p, hkv_p, g_p = L.padded_heads(cfg)
    assert (hq_p, hkv_p, g_p) == (16, 16, 1)
    q_slot, kv_of = L._head_maps(cfg)
    hd, dm = cfg.hd, cfg.d_model
    wq = m.attn["wq"].reshape(cfg.layers, dm, hq_p, hd)
    wo = m.attn["wo"].reshape(cfg.layers, hq_p, hd, dm)
    dummy = sorted(set(range(hq_p)) - set(q_slot.tolist()))
    assert len(dummy) == hq_p - cfg.heads
    assert not wq[:, :, dummy].any() and not wo[:, dummy].any()
    wk = m.attn["wk"].reshape(cfg.layers, dm, hkv_p, hd)
    for j in range(hkv_p):
        torch.testing.assert_close(wk[:, :, j], wk[:, :, kv_of.tolist()
                                                   .index(kv_of[j])])
    np.testing.assert_array_equal(_np(m.attn["wk"]),
                                  np.asarray(params["attn"]["wk"]))


def test_own_init_has_the_padded_layout():
    cfg = get_config(ARCH).smoke().scaled(tp_pad=16)
    m = LM(cfg, device="cpu")
    jm = JLM(jget_config(ARCH).smoke().scaled(tp_pad=16))
    want = jax.tree.map(lambda a: (a.shape, str(a.dtype)),
                        jm.init(jax.random.PRNGKey(0)))
    for key, t in m.state_dict().items():
        top, leaf = key.split(".")
        assert (tuple(t.shape), str(t.dtype).replace("torch.", "")) == \
            (tuple(want[top][leaf][0]), want[top][leaf][1]), key
    q_slot, _ = L._head_maps(cfg)
    dummy = sorted(set(range(16)) - set(q_slot.tolist()))
    wq = m.attn["wq"].reshape(cfg.layers, cfg.d_model, 16, cfg.hd)
    assert not wq[:, :, dummy].any() and wq[:, :, q_slot].abs().sum() > 0


def test_rope_matches_reference():
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 9, 3, 16)).astype(np.float32)
    pos = np.broadcast_to(np.arange(5, 14)[None], (2, 9))
    want = JL.rope(jnp.asarray(x), jnp.asarray(pos), 5e5)
    got = L.rope(torch.from_numpy(x), torch.from_numpy(pos.copy()), 5e5)
    np.testing.assert_allclose(got.numpy(), _np(want), atol=1e-5, rtol=1e-5)


def test_full_config_parameter_count():
    """llama3.2-3b with the reference's TP padding (32 q slots, 16 kv heads):
    the count's formula is held to the port's smoke LM with the same
    padding."""
    def count(c):
        hq_p, hkv_p, _ = L.padded_heads(c)
        d, hd = c.d_model, c.hd
        per_layer = (2 * d * hq_p * hd + 2 * d * hkv_p * hd + d
                     + 3 * d * c.d_ff + d)
        return per_layer, c.layers * per_layer + c.padded_vocab * d + d

    small = get_config(ARCH).smoke().scaled(tp_pad=16)
    assert count(small)[1] == sum(
        p.numel() for p in LM(small, device="cpu").parameters())
    full = get_config(ARCH)
    assert L.padded_heads(full) == (32, 16, 2)
    per_layer, total = count(full)
    assert per_layer == 113_252_352
    assert total == 3_565_071_360


def test_config_copy_is_the_reference():
    assert dataclasses.asdict(get_config(ARCH)) == \
        dataclasses.asdict(jget_config(ARCH))
