"""The port's sharding rules and the train step on a mesh.

- Rules, exactly, at full size: for all ten ``--arch`` on the production
  meshes (16 x 16 ``data, model`` and 2 x 16 x 16 ``pod, data, model``),
  every parameter, AdamW moment, batch and cache leaf of every cell in
  ``cells(arch)`` gets the reference's spec (``tuple(PartitionSpec)``)
  from the port's ``spec_for``, and the port's ``param_shardings``,
  ``opt_shardings``, ``batch_shardings`` and ``cache_shardings`` give the
  DTensor placements of the reference's specs. The reference runs on a
  ``jax.sharding.AbstractMesh`` in this process, its shapes from
  ``jax.eval_shape``; nothing is compiled.
- The sharded step, on four gloo ranks (a 2 x 2 ``data, model`` mesh, one
  spawn of four processes): smoke llama3.2-3b and mamba2-370m in float32,
  two ``make_train_step`` steps on DTensors placed by the rules against
  the same two steps on one device. Tolerances: losses within 1e-5 and
  grad norms within 2e-5 relative (the mesh reorders the reductions; the
  first step's losses agree to 1e-7, the second's differ by up to 1.5e-6
  relative and its grad norms by up to 8.6e-6, after an AdamW step that
  amplifies the first step's differences); each gradient of the first
  step within 1e-4 of
  its largest entry; the parameters after two steps within 2 * lr * 2
  absolute, since AdamW's first steps move an entry by about lr times the
  sign of its gradient, and an entry near zero can flip sign. (On a 1 x 1
  mesh the sharded step is bit-equal to the one-device step: the card's
  ``chip_smoke.py`` ``[sharded]`` gates it at llama3.2-3b's full width.)
  The spawn also runs ``train.main(["--model-axis", "2",
  ...], device="cpu")``, saves a checkpoint on the 2 x 2 mesh, restores
  it with ``shardings=`` onto a 4 x 1 mesh, and ``remesh``es the state
  onto 4 x 1: every tensor equal to the saved one, bit for bit.
"""

import json
import multiprocessing as mp
import os
import time

import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import get_config as rget_config
from repro.configs.base import SHAPES as RSHAPES
from repro.data.pipeline import make_batch_specs as rbatch_specs
from repro.models.model import LM as RLM
from repro.runtime import steps as rsteps
from repro_torch.configs import ARCHS, cells, get_config
from repro_torch.configs.base import SHAPES
from repro_torch.data.pipeline import batch_logical_dims, make_batch_specs
from repro_torch.models.model import LM
from repro_torch.runtime import sharding as shd
from repro_torch.runtime import steps

MESHES = {"pod16x16": ((16, 16), ("data", "model")),
          "pod2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
WORLD = 4
TIMEOUT_S = 240
LR = 1e-3


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + k + "."))
        else:
            out[prefix + k] = v
    return out


def _ref_specs(arch, sizes, names):
    """The reference's specs for the arch's params, moments, and each
    cell's batch or decode inputs: {group: {leaf: tuple(spec)}}."""
    mesh = AbstractMesh(sizes, names)
    cfg = rget_config(arch)
    model = RLM(cfg)
    ps = rsteps.abstract_params(model)

    def specs(tree):
        return {k: tuple(v.spec) for k, v in _flat(tree).items()}

    out = {"params": specs(rsteps.param_shardings(mesh, model, ps))}
    opt = rsteps.opt_shardings(mesh, model, ps)
    out["mu"], out["nu"] = specs(opt["mu"]), specs(opt["nu"])
    out["step"] = {"step": tuple(opt["step"].spec)}
    for shape in cells(arch):
        cell = RSHAPES[shape]
        if cell.kind in ("train", "prefill"):
            b = rbatch_specs(cfg, cell)
            out[shape] = specs(rsteps.batch_shardings(mesh, cfg, b))
            continue
        toks = rbatch_specs(cfg, cell, for_decode=True)
        enc = 4096 if cfg.family == "encdec" else 0
        cache = rsteps.abstract_cache(model, cell.global_batch,
                                      cell.seq_len, enc_len=enc)
        out[shape] = specs(rsteps.cache_shardings(
            mesh, model, cache, cell.global_batch == 1))
        out[shape]["tokens"] = tuple(rsteps.batch_shardings(
            mesh, cfg, dict(tokens=toks["tokens"]))["tokens"].spec)
    return out


def _port(arch, sizes, names):
    """The port's specs ({group: {leaf: spec}}) and placements from its
    helpers ({group: {leaf: placements}})."""
    mesh = dict(zip(names, sizes))
    cfg = get_config(arch)
    model = LM(cfg, device="meta", seed=None)
    ps = steps.abstract_params(model)
    dims = model.param_dims()
    specs = {"params": shd.tree_specs(mesh, dims, ps)}
    opt = steps.abstract_opt(ps)
    specs["mu"] = shd.tree_specs(mesh, dims, opt["mu"])
    specs["nu"] = shd.tree_specs(mesh, dims, opt["nu"])
    specs["step"] = {"step": shd.spec_for(mesh, (), ())}
    pls = {"params": steps.param_shardings(mesh, model, ps)}
    osh = steps.opt_shardings(mesh, model, ps)
    pls["mu"], pls["nu"] = osh["mu"], osh["nu"]
    pls["step"] = {"step": osh["step"]}
    for shape in cells(arch):
        cell = SHAPES[shape]
        if cell.kind in ("train", "prefill"):
            b = make_batch_specs(cfg, cell)
            bd = {k: v for k, v in batch_logical_dims(cfg).items() if k in b}
            specs[shape] = shd.tree_specs(mesh, bd, b)
            pls[shape] = steps.batch_shardings(mesh, cfg, b)
            continue
        toks = make_batch_specs(cfg, cell, for_decode=True)
        enc = 4096 if cfg.family == "encdec" else 0
        cache = steps.abstract_cache(model, cell.global_batch, cell.seq_len,
                                     enc_len=enc)
        pls[shape] = steps.cache_shardings(mesh, model, cache,
                                           cell.global_batch == 1)
        pls[shape]["tokens"] = steps.batch_shardings(
            mesh, cfg, dict(tokens=toks["tokens"]))["tokens"]
        specs[shape] = {"tokens": shd.spec_for(
            mesh, ("batch", "seq"), toks["tokens"][0])}
    return specs, pls


@pytest.mark.parametrize("arch", ARCHS)
def test_specs_and_placements_match_reference(arch):
    checked = 0
    for mesh_name, (sizes, names) in MESHES.items():
        ref = _ref_specs(arch, sizes, names)
        specs, pls = _port(arch, sizes, names)
        mesh = dict(zip(names, sizes))
        assert set(ref) == set(pls), (mesh_name, set(ref) ^ set(pls))
        for group, leaves in ref.items():
            assert set(leaves) == set(pls[group]), (mesh_name, group)
            for leaf, spec in leaves.items():
                where = (mesh_name, group, leaf)
                if leaf in specs[group]:
                    assert specs[group][leaf] == spec, where
                assert pls[group][leaf][1] == shd.placements(mesh, spec), \
                    where
                checked += 1
    assert checked > 0


def test_placements_put_the_pod_axis_major():
    from torch.distributed.tensor import Replicate, Shard

    mesh = {"pod": 2, "data": 16, "model": 16}
    spec = shd.spec_for(mesh, ("batch", None, "vocab"), (256, 8, 64))
    assert spec == (("pod", "data"), None, "model")
    assert shd.placements(mesh, spec) == (Shard(0), Shard(0), Shard(2))
    assert shd.placements(mesh, (None, None, None)) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="mesh order"):
        shd.placements(mesh, (("data", "pod"),))


# ----------------------------------------------------- four gloo ranks

def _cfg(arch):
    return get_config(arch).smoke().scaled(dtype="float32")


def _steps(arch, mesh, n=2):
    """``n`` train steps of the arch's float32 smoke model, on ``mesh`` if
    given (placed by the rules), else on one device: losses, grad norms,
    the first step's gradients and the final parameters, all whole."""
    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.optim.adamw import adamw_init

    cfg = _cfg(arch)
    model = LM(cfg, device="cpu")
    step = steps.make_train_step(model, lr=LR)
    params = dict(model.named_parameters())
    if mesh is not None:
        params = steps.place_params(
            model, steps.param_shardings(mesh, model, params))
    opt = adamw_init(params)
    if mesh is not None:
        opt = steps.place(opt, steps.opt_shardings(mesh, model, params))
    data = SyntheticTokens(cfg, seq_len=16, global_batch=4)
    out = dict(loss=[], grad_norm=[])
    for i in range(n):
        batch = data.batch(i)
        if mesh is not None:
            batch = steps.place(batch, steps.batch_shardings(mesh, cfg,
                                                             batch))
        if i == 0:
            _, grads = steps.value_and_grad(model, params, batch)
            out["grads"] = {k: _whole(g) for k, g in grads.items()}
        _, opt, met = step(params, opt, batch)
        out["loss"].append(float(met["loss"]))
        out["grad_norm"].append(float(met["grad_norm"]))
    out["params"] = {k: _whole(p) for k, p in params.items()}
    return out


def _whole(t):
    from torch.distributed.tensor import DTensor
    return (t.full_tensor() if isinstance(t, DTensor) else t).detach()


def _save(out_dir, rank, name, res):
    if rank:
        return
    np.savez(os.path.join(out_dir, f"{name}.npz"),
             **{f"grads/{k}": v.numpy() for k, v in res["grads"].items()},
             **{f"params/{k}": v.numpy() for k, v in res["params"].items()})
    with open(os.path.join(out_dir, f"{name}.json"), "w") as f:
        json.dump(dict(loss=res["loss"], grad_norm=res["grad_norm"]), f)


def _worker(rank, store_path, out_dir):
    """One rank: every case of the spawn; rank 0 saves the results."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.checkpoint import store
    from repro_torch.launch import train
    from repro_torch.runtime.supervisor import remesh

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, WORLD),
                            rank=rank, world_size=WORLD)
    try:
        mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data",
                                                               "model"))
        for arch in ("llama3.2-3b", "mamba2-370m"):
            _save(out_dir, rank, f"{arch}-one", _steps(arch, None))
            _save(out_dir, rank, f"{arch}-mesh", _steps(arch, mesh))
        state = train.main(["--arch", "llama3.2-3b", "--smoke", "--steps",
                            "3", "--seq", "16", "--batch", "4",
                            "--model-axis", "2", "--ckpt-every", "2",
                            "--ckpt-dir", os.path.join(out_dir, "cli")],
                           device="cpu")
        saved = {k: _whole(v) for k, v in
                 _flat(dict(params=state["params"], opt=state["opt"])).items()}
        tree = dict(params=state["params"], opt=state["opt"])
        store.save_checkpoint(os.path.join(out_dir, "ckpt"), 5, tree)
        mesh41 = init_device_mesh("cpu", (4, 1), mesh_dim_names=("data",
                                                                 "model"))
        model = LM(_cfg("llama3.2-3b").scaled(dtype="bfloat16"),
                   device="meta", seed=None)
        pshape = steps.abstract_params(model)
        new = dict(params=steps.param_shardings(mesh41, model, pshape),
                   opt=steps.opt_shardings(mesh41, model, pshape))
        restored, _ = store.load_checkpoint(os.path.join(out_dir, "ckpt"),
                                            tree, shardings=new)
        moved = remesh(tree, new)
        checks = {}
        for what, t in (("restored", restored), ("remeshed", moved)):
            flat = _flat(t)
            checks[what] = all(
                torch.equal(_whole(flat[k]), saved[k]) and
                tuple(flat[k].device_mesh.shape) == (4, 1) for k in saved)
        if rank == 0:
            with open(os.path.join(out_dir, "cli.json"), "w") as f:
                json.dump(dict(history=state["history"], **checks,
                               files=sorted(os.listdir(
                                   os.path.join(out_dir, "cli")))), f)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_worker, args=(r, str(tmp / "store"),
                                               str(tmp)))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + TIMEOUT_S
    try:
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        alive = [p.pid for p in procs if p.is_alive()]
        assert not alive, f"ranks {alive} still running after {TIMEOUT_S} s"
        codes = [p.exitcode for p in procs]
        assert codes == [0] * WORLD, f"rank exit codes {codes}"
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
    return tmp


def _load(ranks, name):
    with open(ranks / f"{name}.json") as f:
        met = json.load(f)
    with np.load(ranks / f"{name}.npz") as z:
        arrays = dict(z)
    return met, arrays


@pytest.mark.parametrize("arch", ["llama3.2-3b", "mamba2-370m"])
def test_sharded_step_matches_one_device(ranks, arch):
    one, one_a = _load(ranks, f"{arch}-one")
    mesh, mesh_a = _load(ranks, f"{arch}-mesh")
    np.testing.assert_allclose(mesh["loss"], one["loss"], rtol=1e-5)
    np.testing.assert_allclose(mesh["grad_norm"], one["grad_norm"],
                               rtol=2e-5)
    assert one["loss"][1] < one["loss"][0] or arch == "mamba2-370m"
    for key, want in one_a.items():
        got = mesh_a[key]
        assert got.shape == want.shape, key
        if key.startswith("grads/"):
            scale = max(float(np.abs(want).max()), 1e-30)
            assert float(np.abs(got - want).max()) <= 1e-4 * scale, key
        else:
            assert float(np.abs(got - want).max()) <= 2 * LR * 2, key


def test_train_cli_restore_and_remesh_on_a_mesh(ranks):
    with open(ranks / "cli.json") as f:
        res = json.load(f)
    hist = res["history"]
    assert len(hist) == 3 and all(np.isfinite(hist))
    assert res["files"] == ["step_0000000002", "step_0000000003"]
    assert res["restored"] and res["remeshed"]


def test_remat_recomputes_and_keeps_the_gradients():
    """``LM(cfg, remat="dots")`` (the dry-run's ``--remat dots``) recomputes
    each decoder layer in the backward: the same loss and gradients, bit
    for bit, on one device."""
    from repro_torch.data.pipeline import SyntheticTokens

    cfg = _cfg("llama3.2-3b")
    batch = SyntheticTokens(cfg, seq_len=16, global_batch=2).batch(0)
    out = []
    for remat in ("none", "dots"):
        model = LM(cfg, device="cpu", remat=remat)
        model.requires_grad_(True)
        out.append(steps.value_and_grad(model, dict(model.named_parameters()),
                                        batch))
    assert torch.equal(out[0][0], out[1][0])
    for k, g in out[0][1].items():
        assert torch.equal(g, out[1][1][k]), k
    with pytest.raises(ValueError, match="remat"):
        LM(cfg, device="cpu", remat="full")
