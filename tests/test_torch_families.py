"""The port's vlm, moe, hybrid and encdec LMs against the reference, on
carried parameters.

Each family's reference smoke config, ``LM(cfg.smoke()).init(PRNGKey(7))``,
is carried into the port (``import_lm_params``): ``llava-next-mistral-7b``
(vlm), ``granite-moe-1b-a400m`` and ``arctic-480b`` (moe; arctic with the
dense MLP beside the experts), ``zamba2-7b`` (hybrid) and
``seamless-m4t-large-v2`` (encdec). Forward logits, ``decode_step`` logits
and every cache tensor, the prefill's cache and the serve loop's greedy
tokens are compared with the JAX package's: float32 within 1e-4 (the two
frameworks sum in different orders) and the model's bfloat16 within 5e-2
(as ``tests/test_arch_smoke.py``).

The reference is compiled with ``xla_allow_excess_precision`` off. With it
on (XLA's default) a fusion may keep bfloat16 intermediates in float32,
so the jitted reference rounds where its fusions fall; the port rounds
after every op, as the reference's ops are written (``_Ref``). Its float32
results do not change.
"""

import dataclasses
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.launch.serve as jserve
from repro.configs import get_config as jget_config
from repro.models import layers as JL
from repro.models.model import LM as JLM
from repro_torch.configs import ARCHS, get_config
from repro_torch.kernels import ops
from repro_torch.launch import serve
from repro_torch.models import layers as L
from repro_torch.models.carry import import_lm_params
from repro_torch.models.model import LM

VLM, MOE, ARCTIC = ("llava-next-mistral-7b", "granite-moe-1b-a400m",
                    "arctic-480b")
HYBRID, ENCDEC = "zamba2-7b", "seamless-m4t-large-v2"
NEW = (VLM, MOE, ARCTIC, HYBRID, ENCDEC)
ATTENTION = (VLM, MOE, ARCTIC, ENCDEC)      # prefill fills k, v (and enc)
DTYPES = ("float32", "bfloat16")
TOL = {"float32": dict(atol=1e-4, rtol=1e-4),
       "bfloat16": dict(atol=5e-2, rtol=5e-2)}
B, S, T_ENC = 2, 20, 12       # batch, tokens, an encdec's frames (T != S)
MAX_SEQ = 16                  # every teacher-forced cache (one compile)
_EXACT = {"xla_allow_excess_precision": False}


class _Ref:
    """The reference LM and its params; ``call(name, *args)`` runs its
    method ``name`` jitted, compiled once per argument shapes with excess
    precision off (module docstring)."""

    def __init__(self, jm, params):
        self.jm, self.params, self._compiled = jm, params, {}

    def call(self, name, *args):
        key = (name, str(jax.tree.map(lambda a: (a.shape, a.dtype), args)))
        if key not in self._compiled:
            fn = jax.jit(getattr(self.jm, name))
            self._compiled[key] = fn.lower(self.params, *args).compile(
                compiler_options=_EXACT)
        return self._compiled[key](self.params, *args)


_PAIRS = {}


def _cfgs(arch, dtype, **kw):
    return (get_config(arch).smoke().scaled(dtype=dtype, **kw),
            jget_config(arch).smoke().scaled(dtype=dtype, **kw))


def _no_drop(cfg):
    """The capacity factor E / k: every expert has a slot for every token
    of a batch row, so no sequence length drops a token."""
    return dict(capacity_factor=cfg.num_experts / cfg.top_k)


def pair(arch, dtype, no_drop=False):
    """(reference, port LM on the CPU with the same parameters), built once
    per module."""
    key = (arch, dtype, no_drop)
    if key not in _PAIRS:
        kw = _no_drop(get_config(arch).smoke()) if no_drop else {}
        cfg, jcfg = _cfgs(arch, dtype, **kw)
        jm = JLM(jcfg)
        params = jm.init(jax.random.PRNGKey(7))
        m = import_lm_params(LM(cfg, device="cpu"),
                             jax.tree.map(np.asarray, params))
        _PAIRS[key] = (_Ref(jm, params), m)
    return _PAIRS[key]


def _is_moe(arch):
    return get_config(arch).family == "moe"


def _batch(cfg, seed, s=S, t=T_ENC, b=B):
    """numpy inputs from a seed: tokens, and patches (vlm) or frames
    (encdec) of the scale ``SyntheticTokens`` draws."""
    rng = np.random.default_rng(seed)
    out = dict(tokens=rng.integers(0, cfg.vocab, (b, s)).astype(np.int32))
    if cfg.family == "vlm":
        out["patches"] = (rng.standard_normal(
            (b, cfg.num_patches, cfg.d_model)) * 0.02).astype(np.float32)
    if cfg.family == "encdec":
        out["frames"] = (rng.standard_normal((b, t, cfg.d_model)) * 0.02
                         ).astype(np.float32)
    return out


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      jnp.asarray(x, jnp.float32))


def _close(got, want, dtype):
    np.testing.assert_allclose(_np(got), _np(want), **TOL[dtype])


def _close_state(got, want, dtype):
    """Hidden states (a cache's k, v, enc, conv and ssm tensors) within the
    tolerance of their largest value: an encdec's encoder states reach 41
    at the reference's init (fault 5), where float32's different summation
    orders differ by 2e-4 on entries near 1."""
    want = _np(want)
    tol = TOL[dtype]["atol"] * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(_np(got), want, atol=tol, rtol=tol)


def _caches(ref, m, batch, max_seq=MAX_SEQ):
    """Empty caches of both packages; an encdec's ``enc`` is each
    package's encoder pass over the frames, as both serve loops set it."""
    t = batch["frames"].shape[1] if "frames" in batch else 0
    jcache = ref.jm.init_cache(B, max_seq, enc_len=t)
    cache = m.init_cache(B, max_seq, enc_len=t)
    if "frames" in batch:
        jcache["enc"] = ref.call("_encoder", jnp.asarray(batch["frames"]))
        cache["enc"] = m._encoder(torch.from_numpy(batch["frames"]))
    return jcache, cache


def _teacher_forced(ref, jcache, toks):
    """The reference's cache after teacher-forcing ``toks`` through its
    ``decode_step``, and the logits of each step."""
    logits = []
    for t in range(toks.shape[1]):
        lg, jcache = ref.call("decode_step", jcache,
                              jnp.asarray(toks[:, t:t + 1]))
        logits.append(lg)
    return jcache, logits


# ------------------------------------------------------------- the models

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", NEW)
def test_forward_matches_reference(arch, dtype):
    """S = 20 tokens; a vlm's 8 patches before them, an encdec's 12 frames
    (S != T: cross-attention is rectangular)."""
    ref, m = pair(arch, dtype)
    batch = _batch(m.cfg, 1)
    want = ref.call("forward", _j(batch))
    got = m.forward(_t(batch))
    assert got.dtype == L.dtype_of(m.cfg)
    extra = m.cfg.num_patches if m.cfg.family == "vlm" else 0
    assert tuple(got.shape) == (B, S + extra, m.cfg.padded_vocab)
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", NEW)
def test_decode_steps_match_reference(arch, dtype):
    """4 decode steps: logits each step, then every cache tensor (k, v and
    an encdec's enc; a hybrid's conv, ssm and shared-attention k, v)."""
    ref, m = pair(arch, dtype)
    batch = _batch(m.cfg, 2, s=4)
    jcache, cache = _caches(ref, m, batch)
    assert set(cache) == set(jcache)
    jcache, jlogits = _teacher_forced(ref, jcache, batch["tokens"])
    for t in range(4):
        got, cache = m.decode_step(
            cache, torch.from_numpy(batch["tokens"][:, t:t + 1]))
        _close(got, jlogits[t], dtype)
    assert int(cache["pos"]) == int(jcache["pos"]) == 4
    for k in jcache:
        assert tuple(cache[k].shape) == tuple(jcache[k].shape), k
        if k == "pos":
            assert cache[k].dtype == torch.int32
            continue
        assert cache[k].dtype == (torch.float32 if jcache[k].dtype ==
                                  jnp.float32 else L.dtype_of(m.cfg)), k
        _close_state(cache[k], jcache[k], dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ATTENTION)
def test_prefill_cache_matches_teacher_forced_reference(arch, dtype):
    """The port's prefill writes k and v (and an encdec's enc) in the same
    pass as the logits; the cache equals the reference's teacher-forced
    one (fault 4: the reference's own prefill leaves them at zero). A vlm
    prefills text here (teacher-forcing has no patch path); the moe models
    run at the capacity factor E / k, where S = 1 and S = 7 route alike
    (at the default capacity a prefill drops tokens that decode keeps:
    ``test_moe_prefill_and_decode_route_differently``)."""
    ref, m = pair(arch, dtype, no_drop=_is_moe(arch))
    batch = _batch(m.cfg, 3, s=7)
    batch.pop("patches", None)
    jcache, _ = _caches(ref, m, batch)
    jcache, _ = _teacher_forced(ref, jcache, batch["tokens"])
    cache = m.init_cache(B, MAX_SEQ,
                         enc_len=T_ENC if "frames" in batch else 0)
    logits, out = m.prefill(_t(batch), cache)
    assert out is cache and int(cache["pos"]) == int(jcache["pos"]) == 7
    for k in jcache:
        if k != "pos":
            _close_state(cache[k], jcache[k], dtype)
    assert not cache["k"][:, :, :, 7:].any()
    torch.testing.assert_close(logits, m.forward(_t(batch)), rtol=0, atol=0)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ATTENTION)
def test_decode_after_prefill_matches_forward(arch, dtype):
    """A decode step after a ``prefill``-filled cache against the
    reference's forward over one more token; a vlm's prefill takes its
    patches (P + S positions of cache)."""
    ref, m = pair(arch, dtype, no_drop=_is_moe(arch))
    batch = _batch(m.cfg, 1)
    head = dict(batch, tokens=batch["tokens"][:, :S - 1])
    extra = m.cfg.num_patches if m.cfg.family == "vlm" else 0
    cache = m.init_cache(B, S + extra,
                         enc_len=T_ENC if "frames" in batch else 0)
    m.prefill(_t(head), cache)
    assert int(cache["pos"]) == S - 1 + extra
    got, cache = m.decode_step(cache,
                               torch.from_numpy(batch["tokens"][:, S - 1:]))
    want = ref.call("forward", _j(batch))
    _close(got[:, 0], want[:, S - 1 + extra], dtype)
    assert int(cache["pos"]) == S + extra


@pytest.mark.parametrize("dtype", DTYPES)
def test_hybrid_prefill_returns_forward_and_leaves_cache(dtype):
    """As the ssm family and the reference (fault 2, which extends to the
    shared attention's k and v): the forward logits, the cache as it
    was."""
    ref, m = pair(HYBRID, dtype)
    batch = _batch(m.cfg, 5)
    cache = m.init_cache(B, 32)
    logits, out = m.prefill(_t(batch), cache)
    jlogits, jout = ref.call("prefill", _j(batch), ref.jm.init_cache(B, 32))
    _close(logits, jlogits, dtype)
    assert out is cache and int(out["pos"]) == int(jout["pos"]) == 0
    for k in jout:
        assert not out[k].any() and not np.asarray(jout[k]).any(), k


@pytest.mark.parametrize("arch", (VLM, MOE, ENCDEC))
def test_reference_prefill_writes_no_cache(arch):
    """Fault 4 of the reference, for the vlm, moe and encdec families: its
    ``prefill`` sets ``pos`` and leaves k, v and an encdec's enc at zero;
    the port's fills them."""
    ref, m = pair(arch, "float32")
    batch = _batch(m.cfg, 6, s=8)
    t = T_ENC if "frames" in batch else 0
    _, jout = ref.jm.prefill(ref.params, _j(batch),
                             ref.jm.init_cache(B, 40, enc_len=t))
    extra = m.cfg.num_patches if m.cfg.family == "vlm" else 0
    assert int(jout["pos"]) == 8 + extra
    cache = m.init_cache(B, 40, enc_len=t)
    m.prefill(_t(batch), cache)
    for k in [k for k in jout if k != "pos"]:
        assert float(jnp.abs(jout[k]).max()) == 0.0, k
        assert float(cache[k].abs().max()) > 1e-3, k


def test_encdec_prefill_refuses_frames_that_do_not_fit():
    _, m = pair(ENCDEC, "float32")
    batch = _batch(m.cfg, 7, s=4)
    with pytest.raises(ValueError, match="enc_len"):
        m.prefill(_t(batch), m.init_cache(B, 8))


@pytest.mark.parametrize("arch", NEW)
def test_serve_main_tokens_match_reference(arch, monkeypatch, capsys):
    """Both ``serve.main --smoke`` with the same weights (the reference's
    ``PRNGKey(0)`` init, carried) in float32: the same greedy tokens. An
    encdec attends to its encoder's pass over the frames; a vlm is served
    from its text alone in both (fault 7)."""
    _, jcfg = _cfgs(arch, "float32")
    jparams = jax.tree.map(np.asarray,
                           JLM(jcfg).init(jax.random.PRNGKey(0)))
    monkeypatch.setattr(jserve, "get_config",
                        lambda a: jget_config(a).scaled(dtype="float32"))
    monkeypatch.setattr(serve, "get_config",
                        lambda a: get_config(a).scaled(dtype="float32"))
    monkeypatch.setattr(serve, "LM", lambda c, device, seed: import_lm_params(
        LM(c, device=device, seed=seed), jparams))
    argv = ["--arch", arch, "--smoke", "--batch", "2", "--prompt-len", "6",
            "--tokens", "5"]
    want = np.asarray(jserve.main(argv))
    got = serve.main(argv, device="cpu")
    assert got.dtype == torch.int32 and tuple(got.shape) == (2, 5)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("arch", (HYBRID, ENCDEC))
def test_serve_main_bf16_on_cpu(arch, capsys):
    gen = serve.main(["--arch", arch, "--smoke", "--batch", "2",
                      "--prompt-len", "5", "--tokens", "3"], device="cpu")
    assert tuple(gen.shape) == (2, 3) and gen.dtype == torch.int32
    assert "tok/s" in capsys.readouterr().out


# ------------------------------------------------------------ the experts

def _moe_layer(dtype, **kw):
    """A reference moe smoke layer's params, carried, and its config in
    both packages."""
    cfg, jcfg = _cfgs(MOE, dtype, **kw)
    jp = jax.tree.map(lambda t: t[0],
                      JL.moe_init(jcfg, jax.random.PRNGKey(3), 1))
    p = {k: torch.from_numpy(np.array(np.asarray(v, np.float32))).to(
        L.dtype_of(cfg) if k != "router" else torch.float32)
        for k, v in jp.items()}
    return cfg, jcfg, p, jp


@pytest.mark.parametrize("factor", [0.01, 1.25, 2.0],
                         ids=["capacity-1", "default", "no-drop"])
def test_moe_apply_matches_reference_einsum(factor):
    """``moe_apply`` (dispatch by index) against the reference's one-hot
    einsum form, float32, at a capacity of 1 (nearly every pair dropped),
    the default 1.25 and E / k = 2 (none dropped)."""
    cfg, jcfg, p, jp = _moe_layer("float32", capacity_factor=factor)
    x = np.random.default_rng(8).standard_normal((2, 24, cfg.d_model)) \
        .astype(np.float32)
    want = JL.moe_apply(jcfg, jp, jnp.asarray(x))
    got = L.moe_apply(cfg, p, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL["float32"])
    assert L.capacity(cfg, 24) == {0.01: 1, 1.25: 15, 2.0: 24}[factor]


def test_moe_drop_rule_at_capacity_one():
    """At a capacity of 1 each expert of a batch row takes only the first
    (token, choice) pair that arrives for it, in token order then choice
    order; a token whose pairs are all dropped gets 0 from the experts."""
    cfg, _, p, _ = _moe_layer("float32", capacity_factor=0.01)
    x = torch.from_numpy(np.random.default_rng(9).standard_normal(
        (2, 10, cfg.d_model)).astype(np.float32))
    h = L.rmsnorm(x, p["norm"], cfg.norm_eps)
    _, topi, _, arrival, keep = L.moe_route(cfg, p, h)
    for b in range(2):
        first = {}
        for s in range(10):
            for j in range(cfg.top_k):
                first.setdefault(int(topi[b, s, j]), (s, j))
        kept = {(s, j) for s in range(10) for j in range(cfg.top_k)
                if keep[b, s, j]}
        assert kept == set(first.values())
        assert (arrival[b][~keep[b]] >= 1).all()
    y = L.moe_apply(cfg, p, x)
    dropped = ~keep.any(dim=-1)
    assert dropped.any()
    assert not y[dropped].any() and y[~dropped].abs().amax(-1).min() > 0


def _ref_route(jcfg, jp, h):
    gates = jax.nn.softmax(jnp.asarray(h, jnp.float32) @ jp["router"], -1)
    return np.asarray(gates), np.asarray(jax.lax.top_k(gates, jcfg.top_k)[1])


def test_moe_routing_matches_reference_exactly_in_float32():
    """The port's top-k against ``lax.top_k`` on the same normed states,
    float32: the same experts in the same order, and equal gates, where
    ties are made on purpose (two router columns equal, so every token's
    gates tie): ``lax.top_k`` takes the lower index first."""
    cfg, jcfg, p, jp = _moe_layer("float32")
    h = np.random.default_rng(10).standard_normal((2, 32, cfg.d_model)) \
        .astype(np.float32)
    for tie in (False, True):
        if tie:
            router = np.array(np.asarray(jp["router"]))
            router[:, 2] = router[:, 1]
            jp = dict(jp, router=jnp.asarray(router))
            p = dict(p, router=torch.from_numpy(router))
        gates, topi = _ref_route(jcfg, jp, h)
        got_gates, got_topi, _, _, _ = L.moe_route(cfg, p,
                                                   torch.from_numpy(h))
        np.testing.assert_allclose(got_gates.numpy(), gates, atol=1e-6)
        np.testing.assert_array_equal(got_topi.numpy(), topi)
        if tie:
            both = (topi == 1).any(-1) & (topi == 2).any(-1)
            assert both.any()
            order = np.argmax(topi == 1, -1) < np.argmax(topi == 2, -1)
            assert order[both].all()


def _captured_routes(monkeypatch, arch, batch):
    """Every moe layer's (gates, top-k) in the bf16 forward of the
    reference (compiled as ``_Ref`` does; a callback hands each layer's
    routing out) and of the port, on their own states."""
    ref, m = pair(arch, "bfloat16")
    jroutes, routes = [], []
    real_j, real_t = JL.moe_apply, L.moe_route

    def jspy(cfg, p, x):
        h = JL.rmsnorm(x, p["norm"], cfg.norm_eps)
        gates = jax.nn.softmax(h.astype(jnp.float32) @ p["router"], -1)
        jax.debug.callback(lambda g, t: jroutes.append(
            (np.asarray(g), np.asarray(t))), gates,
            jax.lax.top_k(gates, cfg.top_k)[1], ordered=True)
        return real_j(cfg, p, x)

    def tspy(cfg, p, h):
        out = real_t(cfg, p, h)
        routes.append(out[1].numpy())
        return out
    monkeypatch.setattr(JL, "moe_apply", jspy)
    monkeypatch.setattr(L, "moe_route", tspy)
    want = _Ref(ref.jm, ref.params).call("forward", _j(batch))
    got = m.forward(_t(batch))
    return want, got, jroutes, routes


@pytest.mark.parametrize("arch", (MOE, ARCTIC))
def test_moe_bf16_routing_agrees_or_is_a_near_tie(arch, monkeypatch):
    """In bfloat16 the two packages route each token from their own states.
    Every (layer, token) whose top-k differs must be a near-tie in the
    reference's gates (the k-th and (k+1)-th gates within 1e-2 of each
    other, relative); the disagreements are counted, and the logits are
    held at 5e-2 on every position of a batch row before its first
    disagreement (a flip changes that token's output, and attention
    carries it to every later one)."""
    _, m = pair(arch, "bfloat16")
    k = m.cfg.top_k
    batch = _batch(m.cfg, 11, s=48)
    want, got, jroutes, routes = _captured_routes(monkeypatch, arch, batch)
    assert len(jroutes) == len(routes) == m.cfg.layers
    first = np.full(B, batch["tokens"].shape[1])
    flips = 0
    for (gates, jtopi), topi in zip(jroutes, routes):
        differ = (np.sort(jtopi, -1) != np.sort(topi, -1)).any(-1)
        for b, s in zip(*np.nonzero(differ)):
            g = np.sort(gates[b, s])[::-1]
            assert g[k - 1] - g[k] < 1e-2 * g[k - 1], (b, s)
            first[b] = min(first[b], s)
            flips += 1
    print(f"{arch}: {flips} routing disagreements in "
          f"{m.cfg.layers * B * 48} (layer, token)s")
    for b in range(B):
        np.testing.assert_allclose(_np(got[b, :first[b]]),
                                   _np(want[b, :first[b]]),
                                   **TOL["bfloat16"])


def test_moe_prefill_and_decode_route_differently(monkeypatch):
    """The capacity depends on the sequence length: at S = 1 no token is
    dropped (cap 1, and a token's k choices are k experts), while a
    prefill at the default factor drops some. So decode's logits differ
    from forward's at the positions after a drop, in the reference and
    the port alike; the full config's capacities are 1 and 640."""
    full = get_config(MOE)
    assert (L.capacity(full, 1), L.capacity(full, 2048)) == (1, 640)
    ref, m = pair(MOE, "float32")
    batch = _batch(m.cfg, 12, s=MAX_SEQ)
    kept = []
    real = L.moe_route
    monkeypatch.setattr(L, "moe_route", lambda *a: (
        lambda out: kept.append(bool(out[4].all())) or out)(real(*a)))
    full_logits = _np(m.forward(_t(batch)))
    assert kept and not all(kept)
    monkeypatch.undo()
    jcache, cache = _caches(ref, m, batch)
    _, jlogits = _teacher_forced(ref, jcache, batch["tokens"])
    steps = torch.stack([m.decode_step(cache, torch.from_numpy(
        batch["tokens"][:, t:t + 1]))[0][:, 0] for t in range(MAX_SEQ)], 1)
    np.testing.assert_allclose(_np(steps), np.concatenate(
        [_np(x) for x in jlogits], 1), **TOL["float32"])
    assert np.abs(_np(steps) - full_logits).max() > 1e-2


def test_arctic_dense_residual_adds_the_mlp():
    """arctic-480b's dense MLP runs beside the experts: the carried model
    has ``mlp.*`` next to ``moe.*``, and zeroing the MLP's output weights
    changes the logits (granite has no ``mlp``)."""
    ref, m = pair(ARCTIC, "float32")
    assert m.cfg.dense_residual and {"mlp.w1", "moe.router"} <= \
        set(m.state_dict())
    assert not any(k.startswith("mlp.")
                   for k in pair(MOE, "float32")[1].state_dict())
    batch = _t(_batch(m.cfg, 13, s=6))
    before = m.forward(batch)
    saved = m.mlp["w2"].clone()
    m.mlp["w2"].zero_()
    try:
        assert (m.forward(batch) - before).abs().max() > 1e-3
    finally:
        m.mlp["w2"].copy_(saved)


# --------------------------------------------------- kernels on the path

def _spy(monkeypatch):
    calls = []
    real_a, real_s = ops.attention, ops.ssd
    monkeypatch.setattr(ops, "attention", lambda q, k, v, causal=True: (
        calls.append(("attention", q.shape[2], k.shape[2], causal))
        or real_a(q, k, v, causal=causal)))
    monkeypatch.setattr(ops, "ssd", lambda *a: (
        calls.append(("ssd",)) or real_s(*a)))
    return calls


@pytest.mark.parametrize("arch", (VLM, MOE, HYBRID, ENCDEC))
def test_kernel_calls_of_a_prefill_and_a_decode_step(arch, monkeypatch):
    """What ``ops`` gets on a CUDA tensor goes to K2 (attention) and K3
    (ssd); ``chip_smoke.py`` gates each family's launches on these
    patterns at full width. A prefill: one causal attention a layer (vlm,
    moe; S = T = P + S for a vlm); one SSD a Mamba-2 block and one causal
    attention per shared-block application (hybrid); one non-causal
    attention an encoder layer, then a causal self-attention and a
    non-causal cross-attention (S against the frames' T) a decoder layer
    (encdec). A decode step: only an encdec's cross-attention, S = 1
    against T."""
    cfg = get_config(arch).smoke()
    m = LM(cfg, device="cpu")
    batch = _batch(cfg, 14, s=8)
    cache = m.init_cache(B, 24, enc_len=T_ENC)
    calls = _spy(monkeypatch)
    m.prefill(_t(batch), cache)
    n = 8 + (cfg.num_patches if cfg.family == "vlm" else 0)
    causal = ("attention", n, n, True)
    want = {
        "vlm": [causal] * cfg.layers,
        "moe": [causal] * cfg.layers,
        "hybrid": ([("ssd",)] * cfg.attn_period + [causal]) * m.num_attn_apps
        + [("ssd",)] * (cfg.layers - m.num_attn_apps * cfg.attn_period),
        "encdec": [("attention", T_ENC, T_ENC, False)] * cfg.enc_layers
        + [causal, ("attention", 8, T_ENC, False)] * cfg.layers,
    }[cfg.family]
    assert calls == want
    del calls[:]
    if cfg.family == "encdec":
        cache["enc"] = m._encoder(torch.from_numpy(batch["frames"]))
        del calls[:]
    m.decode_step(cache, torch.from_numpy(batch["tokens"][:, :1]))
    assert calls == ([("attention", 1, T_ENC, False)] * cfg.layers
                     if cfg.family == "encdec" else [])


def _chip_smoke():
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("arch, launches", [
    (VLM, (32, 0)), (MOE, (24, 0)), (HYBRID, (13, 81)), (ENCDEC, (72, 0))])
def test_full_width_launches_a_prefill(arch, launches):
    """The K2 and K3 launches a full-width prefill makes, from the configs
    (as ``test_kernel_calls_of_a_prefill_and_a_decode_step`` counts them
    at smoke size): the counts ``chip_smoke.py`` gates on."""
    cfg = get_config(arch)
    n_attn = (cfg.layers // cfg.attn_period if cfg.family == "hybrid" else
              cfg.enc_layers + 2 * cfg.layers if cfg.family == "encdec" else
              cfg.layers)
    n_ssd = cfg.layers if cfg.family == "hybrid" else 0
    assert (n_attn, n_ssd) == launches
    gates = {a: (k2, k3) for a, k2, k3, _ in _chip_smoke().FAMILIES}
    assert gates[arch] == launches


@pytest.mark.parametrize("arch, heads", [
    (VLM, (32, 16, 2, 128)), (MOE, (16, 16, 1, 64)),
    (HYBRID, (32, 32, 1, 112)), (ENCDEC, (16, 16, 1, 64))])
def test_full_width_attention_shapes(arch, heads):
    """(Hq, Hkv, g) after the TP padding, and the head dim, at full width:
    K2's shapes on the card."""
    cfg = get_config(arch)
    assert L.padded_heads(cfg) + (cfg.hd,) == heads


# -------------------------------------------- parameters and construction

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", NEW)
def test_carried_tree_keys_shapes_and_dtypes(arch, dtype):
    """The port's own init has the reference's tree: every key, shape and
    dtype (``moe.router`` float32 in a bf16 model; ``shared_attn`` and
    ``shared_mlp`` one layer), and the carried values are the
    reference's."""
    ref, m = pair(arch, dtype)
    own = LM(m.cfg, device="cpu")
    want = {f"{top}.{leaf}": a for top, sub in ref.params.items()
            for leaf, a in sub.items()}
    assert set(own.state_dict()) == set(want)
    for key, t in own.state_dict().items():
        assert tuple(t.shape) == tuple(want[key].shape), key
        assert str(t.dtype).replace("torch.", "") == \
            str(want[key].dtype), key
    if m.cfg.family == "moe":
        assert own.moe["router"].dtype == torch.float32
    if m.cfg.family == "hybrid":
        assert own.shared_attn["wq"].shape[0] == 1
    for key, t in m.state_dict().items():
        np.testing.assert_array_equal(_np(t), np.asarray(want[key],
                                                         np.float32), key)


@pytest.mark.parametrize("arch", ARCHS)
def test_every_arch_builds_on_cpu(arch):
    m = LM(get_config(arch).smoke(), device="cpu")
    assert m.device.type == "cpu"
    out = m.forward(_t(_batch(m.cfg, 15, s=3, t=3, b=1)))
    assert torch.isfinite(out.float()).all()


def test_a_family_the_reference_lacks_raises():
    cfg = dataclasses.replace(get_config(MOE).smoke(), family="diffusion")
    with pytest.raises(NotImplementedError, match="diffusion"):
        LM(cfg, device="cpu")


@pytest.mark.parametrize("arch", (VLM, MOE, HYBRID, ENCDEC))
def test_lm_defaults_to_cuda_and_raises_without_gpu(arch, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        LM(get_config(arch).smoke())
    with pytest.raises(RuntimeError, match="cuda"):
        serve.main(["--arch", arch, "--smoke"])
