"""The port's checkpoints, supervisor and train CLI.

Checkpoints cross between the packages bit for bit in both directions
(bfloat16 parameters, float32 moments, the int32 step), with the same npz
keys and the same manifest; the reference's supervisor tests
(``tests/test_substrate.py``) run on the port; the train CLI runs on the
CPU when asked and raises on a host without a GPU otherwise.
"""

import json
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint import store as jstore
from repro.configs import get_config as jget_config
from repro.models.model import LM as JLM
from repro.optim.adamw import adamw_init as jadamw_init
from repro_torch.checkpoint import store
from repro_torch.checkpoint.store import CheckpointManager, latest_step
from repro_torch.configs import get_config
from repro_torch.data.pipeline import SyntheticTokens
from repro_torch.launch import train
from repro_torch.models.model import LM
from repro_torch.optim.adamw import adamw_init
from repro_torch.runtime.steps import make_train_step
from repro_torch.runtime.supervisor import StepStats, TrainSupervisor

ARCH = "llama3.2-3b"
CFG = get_config(ARCH).smoke()



@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this module runs: its tensors are small,
    and idle worker threads spinning in several test processes at once
    slow every process on the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + k + "/"))
        else:
            out[prefix + k] = v
    return out


def _bits(a):
    """A leaf as comparable numpy bits: bfloat16 as uint16."""
    if isinstance(a, torch.Tensor):
        a = a.detach()
        if a.dtype == torch.bfloat16:
            return a.view(torch.int16).numpy().view(np.uint16)
        return a.numpy()
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype == ml_dtypes.bfloat16 else a


def _ref_state(seed):
    """The reference's (params, opt) for the bf16 smoke LM, with random
    moments and step 7."""
    jm = JLM(jget_config(ARCH).smoke())
    params = jm.init(jax.random.PRNGKey(seed))
    opt = jadamw_init(params)
    rng = np.random.default_rng(seed)
    opt = dict(mu=jax.tree.map(lambda z: jnp.asarray(
        rng.standard_normal(z.shape), jnp.float32), opt["mu"]),
        nu=jax.tree.map(lambda z: jnp.asarray(
            rng.random(z.shape), jnp.float32), opt["nu"]),
        step=jnp.asarray(7, jnp.int32))
    return dict(params=params, opt=opt)


def _port_state(seed=1):
    m = LM(CFG, device="cpu", seed=seed)
    params = dict(m.named_parameters())
    return m, dict(params=params, opt=adamw_init(params))


def _same_manifest(a, b):
    a, b = dict(a), dict(b)
    a.pop("time"), b.pop("time")
    assert a == b


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    jstate = _ref_state(3)
    jstore.save_checkpoint(str(tmp_path), 7, jstate, extra=dict(loss=1.5))
    m, state = _port_state()
    live = state["params"]["embed.tok"]
    got, manifest = store.load_checkpoint(str(tmp_path), state)
    assert got is state and state["params"]["embed.tok"] is live
    assert manifest["step"] == 7 and manifest["format"] == "npz-v1"
    assert manifest["extra"] == dict(loss=1.5)
    want = _flat(jstate)
    have = {k: v for k, v in store._flatten(state)}
    assert set(have) == set(want)
    for k, w in want.items():
        assert _bits(have[k]).dtype == _bits(w).dtype, k
        assert np.array_equal(_bits(have[k]), _bits(w)), k
    assert state["opt"]["step"].dtype == torch.int32
    assert m.embed["tok"].dtype == torch.bfloat16


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    m, state = _port_state(seed=5)
    with torch.no_grad():
        g = torch.Generator().manual_seed(0)
        for t in state["opt"]["mu"].values():
            t.copy_(torch.randn(t.shape, generator=g))
        state["opt"]["step"].fill_(11)
    store.save_checkpoint(str(tmp_path), 11, state)
    like = _ref_state(0)
    got, manifest = jstore.load_checkpoint(str(tmp_path), like)
    assert manifest["step"] == 11
    have = {k: v for k, v in store._flatten(state)}
    for k, w in _flat(got).items():
        assert np.array_equal(_bits(w), _bits(have[k])), k
        assert _bits(w).dtype == _bits(_flat(like)[k]).dtype, k


def test_both_packages_write_the_same_files(tmp_path):
    """The same state saved by each package: the same npz keys and arrays
    (bfloat16 widened to float32), and the same manifest but its time."""
    jstate = _ref_state(4)
    _, state = _port_state()
    store.load_checkpoint(_save_ref(tmp_path / "a", jstate), state)
    store.save_checkpoint(str(tmp_path / "b"), 3, state)
    jstore.save_checkpoint(str(tmp_path / "c"), 3, jstate)
    files = []
    for d in ("b", "c"):
        step = tmp_path / d / "step_0000000003"
        with np.load(step / "arrays.npz") as z:
            arrays = {k: z[k] for k in z.files}
        files.append((arrays, json.loads((step / "manifest.json").read_text())))
    (pa, pm), (ja, jm) = files
    _same_manifest(pm, jm)
    assert set(pa) == set(ja) == set(pm["keys"])
    assert "params/embed/tok" in pa and "opt/mu/attn/wq" in pa and \
        "opt/step" in pa
    for k in pa:
        assert pa[k].dtype == ja[k].dtype and np.array_equal(pa[k], ja[k]), k


def _save_ref(path, jstate):
    jstore.save_checkpoint(str(path), 1, jstate)
    return str(path)


def test_keep_last_k_and_restore(tmp_path):
    _, state = _port_state()
    ckpt = CheckpointManager(str(tmp_path / "ckpt"), keep=2)
    for s in (10, 20, 30):
        ckpt.save(s, state)
    assert ckpt.latest() == 30 == latest_step(ckpt.dir)
    assert sorted(os.listdir(ckpt.dir)) == ["step_0000000020",
                                            "step_0000000030"]
    saved = {k: _bits(v).copy() for k, v in store._flatten(state)}
    with torch.no_grad():
        for p in state["params"].values():
            p.zero_()
    restored, manifest = ckpt.restore(state)
    assert manifest["step"] == 30
    for k, v in store._flatten(restored):
        assert np.array_equal(_bits(v), saved[k]), k


def test_restore_checks_keys_and_shapes(tmp_path):
    _, state = _port_state()
    store.save_checkpoint(str(tmp_path), 1, state)
    extra = dict(state, more={"x": torch.zeros(2)})
    with pytest.raises(KeyError):
        store.load_checkpoint(str(tmp_path), extra)
    bad = dict(params=dict(state["params"]), opt=state["opt"])
    bad["params"]["embed.tok"] = torch.zeros(3, 4, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="embed/tok"):
        store.load_checkpoint(str(tmp_path), bad)
    with pytest.raises(FileNotFoundError):
        store.load_checkpoint(str(tmp_path / "none"), state)
    assert not [n for n in os.listdir(tmp_path) if n.startswith(".tmp")]


# ------------------------------------------------------------- supervisor

def _setup(tmp):
    model = LM(CFG, device="cpu", seed=0)
    step = make_train_step(model, lr=1e-3)
    params = dict(model.named_parameters())
    opt = adamw_init(params)
    data = SyntheticTokens(CFG, seq_len=16, global_batch=4)
    ckpt = CheckpointManager(os.path.join(tmp, "ckpt"), keep=2)
    return model, params, opt, data, step, ckpt


def test_supervisor_trains_and_checkpoints(tmp_path):
    model, params, opt, data, step, ckpt = _setup(str(tmp_path))
    sup = TrainSupervisor(step, data.batch, ckpt, ckpt_every=5)
    state = sup.run(dict(params=params, opt=opt), 0, 15)
    assert ckpt.latest() == 15
    hist = state["history"]
    assert len(hist) == 15
    assert hist[-1] < hist[0]          # learning happened
    assert int(opt["step"]) == 15


def test_supervisor_recovers_from_injected_faults(tmp_path):
    model, params, opt, data, step, ckpt = _setup(str(tmp_path))
    boom = {"armed": True}

    def fault_hook(step_idx):
        if step_idx == 7 and boom["armed"]:
            boom["armed"] = False
            raise RuntimeError("injected device failure")

    sup = TrainSupervisor(step, data.batch, ckpt, ckpt_every=3,
                          fault_hook=fault_hook)
    state = sup.run(dict(params=params, opt=opt), 0, 12)
    assert sup.stats.retries == 1
    assert sup.stats.restores == 1
    assert len(state["history"]) >= 12 - 6   # rolled back to step 6 ckpt
    assert ckpt.latest() == 12


def test_supervisor_rolls_back_a_non_finite_loss(tmp_path):
    """A NaN loss after the update has written the parameters: the
    rollback copies the newest checkpoint into the live tensors, and the
    replayed steps give the uninterrupted run's losses."""
    model, params, opt, data, step, ckpt = _setup(str(tmp_path))
    clean = TrainSupervisor(step, data.batch,
                            CheckpointManager(str(tmp_path / "clean")),
                            ckpt_every=3)
    want = clean.run(dict(params=params, opt=opt), 0, 6)["history"]
    model, params, opt, data, step, ckpt = _setup(str(tmp_path))
    calls = []

    def poisoned(p, o, batch):
        p, o, met = step(p, o, batch)
        calls.append(1)
        if len(calls) == 5:
            with torch.no_grad():
                p["embed.tok"].fill_(float("nan"))
            met = dict(met, loss=torch.tensor(float("nan")))
        return p, o, met

    sup = TrainSupervisor(poisoned, data.batch, ckpt, ckpt_every=3)
    state = sup.run(dict(params=params, opt=opt), 0, 6)
    assert sup.stats.retries == 1 and sup.stats.restores == 1
    assert torch.isfinite(params["embed.tok"].float()).all()
    np.testing.assert_allclose(state["history"][-2:], want[-2:], rtol=1e-6)


def test_supervisor_restart_resumes(tmp_path):
    model, params, opt, data, step, ckpt = _setup(str(tmp_path))
    sup = TrainSupervisor(step, data.batch, ckpt, ckpt_every=5)
    sup.run(dict(params=params, opt=opt), 0, 10)
    # "process restarted": fresh supervisor resumes from step 10, not 0
    model, params, opt, data, step, _ = _setup(str(tmp_path))
    sup2 = TrainSupervisor(step, data.batch, ckpt, ckpt_every=5)
    state = sup2.run(dict(params=params, opt=opt), 0, 12)
    assert len(state["history"]) == 2      # only steps 10..12 re-run
    assert int(opt["step"]) == 12


def test_straggler_detection():
    st = StepStats()
    for _ in range(20):
        st.record(0.1)
    assert st.stragglers == 0
    assert st.record(0.5, factor=2.0)      # 5x median flagged
    assert st.stragglers == 1


# -------------------------------------------------------------------- CLI

def test_train_main_on_cpu(tmp_path, capsys):
    state = train.main(["--arch", ARCH, "--smoke", "--steps", "4",
                        "--seq", "16", "--batch", "4", "--ckpt-every", "2",
                        "--ckpt-dir", str(tmp_path)], device="cpu")
    out = capsys.readouterr().out
    assert "trained 4 steps" in out and "stragglers=0 retries=0" in out
    hist = state["history"]
    assert len(hist) == 4 and hist[-1] < hist[0]
    assert latest_step(str(tmp_path)) == 4
    assert state["params"]["embed.tok"].device.type == "cpu"


def test_train_main_needs_a_gpu_unless_told(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = ["--arch", ARCH, "--smoke", "--steps", "1", "--ckpt-dir",
            str(tmp_path)]
    with pytest.raises(RuntimeError, match="cuda"):
        train.main(args)
    with pytest.raises(ValueError, match="process group"):
        train.main(args + ["--model-axis", "2"], device="cpu")
    assert latest_step(str(tmp_path)) is None
