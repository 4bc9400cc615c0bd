"""The port's AdamW, schedule and train step against the reference.

``adamw_update`` runs once from the same carried parameters, gradients and
moments in both packages: float32 within 1e-6 relative (the two frameworks
may round ``b1 ** step`` and the clip scale an ulp apart), bfloat16
parameters within one bfloat16 ulp (the float32 update rounds to the same
bfloat16 value or its neighbour). ``cosine_schedule`` is compared on a
sweep of steps. ``make_train_step`` runs three steps from carried
``llama3.2-3b`` and ``mamba2-370m`` smoke parameters in both packages,
with one and with two microbatches (the reference's jitted step compiled
with excess precision off, as in ``tests/test_torch_families.py``); and
two microbatches are held against one batch in the port.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models.model import LM as JLM
from repro.optim import adamw as jadamw
from repro.optim.schedule import cosine_schedule as jcosine
from repro.runtime import steps as jsteps
from repro_torch.configs import get_config
from repro_torch.models.carry import import_lm_params
from repro_torch.models.model import LM
from repro_torch.optim import adamw_init, adamw_update, cosine_schedule
from repro_torch.optim.adamw import global_norm
from repro_torch.runtime.steps import make_train_step

_EXACT = {"xla_allow_excess_precision": False}
B, S = 4, 16



@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this module runs: its tensors are small,
    and idle worker threads spinning in several test processes at once
    slow every process on the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

def _torch(a):
    a = np.asarray(a)
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(jnp.asarray(t, jnp.float32))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + k + "."))
        else:
            out[prefix + k] = v
    return out


def _unflat(flat):
    out = {}
    for k, v in flat.items():
        parts = k.split(".")
        d = out
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = v
    return out


def _bf16_ulps(a, b):
    """|a - b| in bfloat16 ulps, elementwise (ordered bit patterns)."""
    def order(t):
        u = t.contiguous().view(torch.int16).numpy().astype(np.int32) & 0xFFFF
        return np.where(u & 0x8000, -(u & 0x7FFF), u)
    return np.abs(order(a) - order(b))


def _carried(arch, dtype):
    """(reference LM, its params, port LM with the same params)."""
    jm = JLM(jget_config(arch).smoke().scaled(dtype=dtype))
    params = jm.init(jax.random.PRNGKey(7))
    m = import_lm_params(
        LM(get_config(arch).smoke().scaled(dtype=dtype), device="cpu"),
        jax.tree.map(np.asarray, params))
    return jm, params, m


# ------------------------------------------------------------------ AdamW

@pytest.mark.parametrize("gscale", [1e-3, 10.0])      # below / above clip
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_reference(dtype, gscale):
    """One update at step 3 from random moments, with gradients whose
    global norm is below the clip (scale 1) and above it. Above it, every
    gradient is scaled by ``clip / norm``, a float32 sum over all
    gradients taken in another order in each framework: the moments then
    agree within 1e-5 (2.3e-6 measured, ``nu``)."""
    _, params, m = _carried("llama3.2-3b", dtype)
    rng = np.random.default_rng(11)
    flat = _flat(params)
    npdt = ml_dtypes.bfloat16 if dtype == "bfloat16" else np.float32

    def draw(p, scale, dt):
        return (rng.standard_normal(p.shape) * scale).astype(dt)

    grads = {k: draw(p, gscale / 30, npdt if p.dtype == jnp.bfloat16
                     else np.float32) for k, p in flat.items()}
    mu = {k: draw(p, 1e-3, np.float32) for k, p in flat.items()}
    nu = {k: np.abs(draw(p, 1e-6, np.float32)) for k, p in flat.items()}
    jstate = dict(mu=_unflat({k: jnp.asarray(v) for k, v in mu.items()}),
                  nu=_unflat({k: jnp.asarray(v) for k, v in nu.items()}),
                  step=jnp.asarray(3, jnp.int32))
    jp, jst = jax.jit(jadamw.adamw_update)(
        params, _unflat({k: jnp.asarray(v) for k, v in grads.items()}),
        jstate, 1e-3)

    tparams = dict(m.named_parameters())
    state = adamw_init(tparams)
    for k in tparams:
        state["mu"][k].copy_(torch.from_numpy(mu[k]))
        state["nu"][k].copy_(torch.from_numpy(nu[k]))
    state["step"].fill_(3)
    out, st = adamw_update(tparams, {k: _torch(g) for k, g in grads.items()},
                           state, 1e-3)
    assert out is tparams and st is state
    assert int(st["step"]) == int(jst["step"]) == 4
    assert st["step"].dtype == torch.int32
    jflat = _flat(jp)
    for k, p in tparams.items():
        want = np.asarray(jflat[k])
        assert p.dtype == m.state_dict()[k].dtype
        if p.dtype == torch.bfloat16:
            assert _bf16_ulps(p.detach(), _torch(want)).max() <= 1, k
        else:
            np.testing.assert_allclose(_np(p), want, rtol=1e-6,
                                       atol=1e-6 * np.abs(want).max(),
                                       err_msg=k)
    rtol = 1e-6 if gscale < 1 else 1e-5
    for name in ("mu", "nu"):
        jm_ = _flat(jst[name])
        for k, t in st[name].items():
            want = np.asarray(jm_[k])
            assert t.dtype == torch.float32
            np.testing.assert_allclose(t.numpy(), want, rtol=rtol,
                                       atol=rtol * np.abs(want).max(),
                                       err_msg=f"{name} {k}")


def test_adamw_init_matches_reference():
    _, params, m = _carried("mamba2-370m", "bfloat16")
    state = adamw_init(dict(m.named_parameters()))
    want = jadamw.adamw_init(params)
    assert state["step"].dtype == torch.int32 and int(state["step"]) == 0
    for name in ("mu", "nu"):
        assert set(state[name]) == set(_flat(want[name]))
        for k, t in state[name].items():
            assert t.dtype == torch.float32 and not t.any()
            assert tuple(t.shape) == _flat(want[name])[k].shape


def test_global_norm_is_float32_over_every_gradient():
    g = {"a": torch.full((3,), 2.0, dtype=torch.bfloat16),
         "b": torch.full((4,), 0.5)}
    n = global_norm(g)
    assert n.dtype == torch.float32 and float(n) == pytest.approx(13 ** 0.5)


@pytest.mark.parametrize("warmup,total", [(0, 100), (10, 100), (20, 21),
                                          (5, 3)])
def test_cosine_schedule_matches_reference(warmup, total):
    for step in (0, 1, 4, 9, 10, 11, 20, 50, 99, 100, 150):
        got = cosine_schedule(step, 3e-4, warmup, total)
        want = jcosine(step, 3e-4, warmup, total)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6,
                                   err_msg=f"step {step}")


# ------------------------------------------------------------- train step

def _batches(cfg, n):
    rng = np.random.default_rng(4)
    return [dict(tokens=rng.integers(0, cfg.vocab, (B, S)).astype(np.int32))
            for _ in range(n)]


TRAIN_TOL = {"float32": 1e-4, "bfloat16": 5e-2}
LR = 1e-3


def _load_state(tparams, opt, params, jopt):
    """Copy the reference's state into the port's tensors."""
    with torch.no_grad():
        for k, v in _flat(params).items():
            tparams[k].copy_(_torch(v))
        for n in ("mu", "nu"):
            for k, v in _flat(jopt[n]).items():
                opt[n][k].copy_(_torch(v))
        opt["step"].fill_(int(jopt["step"]))


@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("arch,dtype", [("llama3.2-3b", "float32"),
                                        ("llama3.2-3b", "bfloat16"),
                                        ("mamba2-370m", "float32")])
def test_train_step_matches_reference(arch, dtype, microbatches):
    """Three steps at lr 1e-3, each from the reference's state after the
    one before (so steps 1, 2 and 3 of the bias correction run): each
    step's loss and grad norm within the tolerance (float32 1e-4, bfloat16
    5e-2), the moments within it times each leaf's largest entry, and the
    parameters within that plus half a learning rate. AdamW divides each
    gradient by its own running magnitude, so an entry whose gradient lies
    at rounding level (the reference's init saturates attention: its q and
    k gradients reach 1e-9) moves by a learning rate's share that rounding
    decides, in either package; 0.2 lr measured (``attn.wq``, step 1).
    Free-running, the two trajectories part by 1.5e-3 of the largest
    gradient entry at step 3 for that reason."""
    jm, params, m = _carried(arch, dtype)
    jstep = jax.jit(jsteps.make_train_step(jm, lr=LR,
                                           microbatches=microbatches))
    step = make_train_step(m, lr=LR, microbatches=microbatches)
    jopt = jadamw.adamw_init(params)
    tparams = dict(m.named_parameters())
    opt = adamw_init(tparams)
    tol = TRAIN_TOL[dtype]
    compiled = None
    for batch in _batches(m.cfg, 3):
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        if compiled is None:
            compiled = jstep.lower(params, jopt, jb).compile(
                compiler_options=_EXACT)
        _load_state(tparams, opt, params, jopt)
        params, jopt, jmet = compiled(params, jopt, jb)
        out, opt, met = step(tparams, opt,
                             {k: torch.from_numpy(v) for k, v in batch.items()})
        assert out is tparams
        for key in ("loss", "grad_norm"):
            assert met[key].dtype == torch.float32
            np.testing.assert_allclose(float(met[key]), float(jmet[key]),
                                       rtol=tol, err_msg=key)
        assert int(opt["step"]) == int(jopt["step"])
        pairs = [("params", tparams, _flat(params), LR / 2)] + \
            [(n, opt[n], _flat(jopt[n]), 0.0) for n in ("mu", "nu")]
        for name, got, want, slack in pairs:
            for k, t in got.items():
                w = _np(want[k])
                bound = tol * float(np.abs(w).max()) + slack
                np.testing.assert_allclose(_np(t), w, atol=bound, rtol=0,
                                           err_msg=f"{name} {k}")
    assert int(opt["step"]) == 3


def test_two_microbatches_match_one_batch():
    """The same step from the same state: loss and grad norm within 1e-5,
    and the parameters after it within 1e-5 of each leaf's largest entry
    (float32: only the summation order differs)."""
    runs = []
    for mb in (1, 2):
        _, _, m = _carried("llama3.2-3b", "float32")
        params = dict(m.named_parameters())
        opt = adamw_init(params)
        batch = {k: torch.from_numpy(v)
                 for k, v in _batches(m.cfg, 1)[0].items()}
        _, _, met = make_train_step(m, lr=1e-3, microbatches=mb)(
            params, opt, batch)
        runs.append((met, {k: p.detach().clone()
                           for k, p in params.items()}))
    (m1, p1), (m2, p2) = runs
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(m2[key]), float(m1[key]),
                                   rtol=1e-5)
    for k in p1:
        bound = 1e-5 * float(p1[k].abs().max())
        np.testing.assert_allclose(p2[k].numpy(), p1[k].numpy(), atol=bound,
                                   rtol=0, err_msg=k)


def test_train_step_checks_its_arguments():
    _, _, m = _carried("llama3.2-3b", "float32")
    params = dict(m.named_parameters())
    opt = adamw_init(params)
    batch = {k: torch.from_numpy(v) for k, v in _batches(m.cfg, 1)[0].items()}
    with pytest.raises(ValueError, match="own parameters"):
        make_train_step(m)({k: p.clone() for k, p in params.items()}, opt,
                           batch)
    with pytest.raises(ValueError, match="microbatches"):
        make_train_step(m, microbatches=3)(params, opt, batch)
    assert all(p.requires_grad for p in m.parameters())
    assert not any(p.requires_grad for p in
                   LM(get_config("llama3.2-3b").smoke(),
                      device="cpu").parameters())
