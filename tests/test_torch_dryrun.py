"""The dry-run (``repro_torch.launch.dryrun``) and its cost accounting
(``repro_torch.runtime.cost``) against the reference's
(``repro.launch.dryrun``, ``repro.runtime.hlo_cost``).

Two subprocesses run for the module, one after the other: the reference
on eight emulated XLA devices (``--xla_force_host_platform_device_count=
8``; nothing larger than a smoke train step is compiled), and the port on
a ``fake`` process group (global state, so never in this process).
Cases:

- the CLI on smoke llama3.2-3b over a fake 2 x 4 mesh (a third
  subprocess): a record with every field of the reference's record
  (``trace_s`` in place of ``compile_s``, which the port has no
  compiler for; ``xla_flops_loop_unaware`` and ``bytes_accessed`` are
  XLA's own analyses and have no counterpart), written under the port's
  ``artifacts_torch/`` and not under ``benchmarks/artifacts/``;
- shard offsets, exact: on a (2, 4) ``data, model`` mesh and a (2, 2, 2)
  ``pod, data, model`` mesh, every parameter of the smoke llama3.2-3b and
  mamba2-370m: each fake rank's local shape and global offset
  (``compute_local_shape_and_global_offset`` of the port's placements)
  equal the reference's ``NamedSharding.devices_indices_map`` for the
  device of the same index;
- argument bytes, exact: llama3.2-3b and mamba2-370m ``train_4k`` on both
  production meshes: the bytes of rank 0's shards of params, moments and
  batch (``dryrun.local_bytes`` of ``abstract_state``, what a record's
  ``memory.argument_bytes`` counts) equal the reference's sum of
  ``NamedSharding.shard_shape`` bytes;
- FLOPs: smoke stablelm-1.6b (dense; its four kv heads split over a model
  axis of 4) and mamba2-370m (ssm) train cells, 8 x 64 on 2 x 4 (the
  reference's mesh built from ``jax.devices()`` in order, device i at
  rank i's coordinate): the port's per-device ``flops`` within [0.95,
  1.1] of the reference's ``analyze_hlo(compiled.as_text()).flops``
  (remat none). Measured: 52,428,800 / 50,331,648 = 1.042 and 73,433,088
  / 67,854,336 = 1.082. The port does more: K2's and K3's backward is the
  plain version recomputed (``kernels.grad.KernelGrad``), so their
  forward products count twice. At stablelm the gap is exactly that,
  2 layers x 1,048,576 (``cost.attention_cost`` of the local (4, 1, 64,
  64, 16) call); at mamba2 it is 5,578,752 against 3 x 2,097,152 for
  ``cost.ssd_cost``'s formula, XLA lowering the SSD's einsums a little
  differently. The moe differs by design: the reference dispatches by
  one-hot ``einsum`` (``src/repro/models/layers.py:260-275``), the port
  by index on its experts' shards (``layers.moe_sharded``); and granite's
  smoke kv heads (2) do not split over 4, so the port runs every head on
  each model rank. Its ratio, 83,099,648 / 65,912,832 = 1.261, is pinned
  within 0.02.
"""

import json
import os
import subprocess
import sys
import textwrap

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = dict(batch=8, seq=64)
FLOP_CELLS = ("stablelm-1.6b", "mamba2-370m", "granite-moe-1b-a400m")
OFFSET_ARCHS = ("llama3.2-3b", "mamba2-370m")
MESHES = {"2x4": ((2, 4), ("data", "model")),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}
ARG_CELLS = [("llama3.2-3b", False), ("llama3.2-3b", True),
             ("mamba2-370m", False), ("mamba2-370m", True)]

COMMON = f"""
import json, math, sys
import numpy as np
FLOP_CELLS = {FLOP_CELLS!r}
OFFSET_ARCHS = {OFFSET_ARCHS!r}
MESHES = {MESHES!r}
ARG_CELLS = {ARG_CELLS!r}
SMOKE = {SMOKE!r}
out = {{}}
"""

REFERENCE = COMMON + """
import jax
from jax.sharding import AbstractMesh, Mesh, NamedSharding
from repro.configs import get_config
from repro.configs.base import SHAPES, ShapeCell
from repro.data.pipeline import make_batch_specs
from repro.models.model import LM
from repro.runtime import steps as rsteps
from repro.runtime.hlo_cost import analyze_hlo

def flat(tree, prefix=""):
    res = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            res.update(flat(v, prefix + k + "."))
        else:
            res[prefix + k] = v
    return res

cell = ShapeCell("t", "train", SMOKE["seq"], SMOKE["batch"])
mesh = Mesh(np.array(jax.devices()).reshape(2, 4), ("data", "model"))
for arch in FLOP_CELLS:
    cfg = get_config(arch).smoke()
    with mesh:
        model = LM(cfg, batch_axes=("data",))
        ps = rsteps.abstract_params(model)
        pshard = rsteps.param_shardings(mesh, model, ps)
        oshard = rsteps.opt_shardings(mesh, model, ps)
        bspec = make_batch_specs(cfg, cell)
        bshard = rsteps.batch_shardings(mesh, cfg, bspec)
        step = jax.jit(rsteps.make_train_step(model),
                       in_shardings=(pshard, oshard, bshard),
                       out_shardings=(pshard, oshard, None))
        txt = step.lower(ps, rsteps.abstract_opt(ps), bspec).compile() \\
            .as_text()
    out["flops/" + arch] = analyze_hlo(txt).flops

for name, (shape, names) in MESHES.items():
    mesh = Mesh(np.array(jax.devices()).reshape(shape), names)
    for arch in OFFSET_ARCHS:
        model = LM(get_config(arch).smoke())
        ps = rsteps.abstract_params(model)
        shard = flat(rsteps.param_shardings(mesh, model, ps))
        for k, leaf in flat(ps).items():
            dmap = shard[k].devices_indices_map(leaf.shape)
            out[f"offsets/{name}/{arch}/{k}"] = [
                [[sl.indices(n)[0], sl.indices(n)[1] - sl.indices(n)[0]]
                 for sl, n in zip(dmap[d], leaf.shape)]
                for d in mesh.devices.flat]

for arch, multi in ARG_CELLS:
    sizes, names = ((2, 16, 16), ("pod", "data", "model")) if multi else \\
        ((16, 16), ("data", "model"))
    mesh = AbstractMesh(sizes, names)
    cfg = get_config(arch)
    model = LM(cfg)
    ps = rsteps.abstract_params(model)
    opt = rsteps.abstract_opt(ps)
    bspec = make_batch_specs(cfg, SHAPES["train_4k"])
    trees = [(ps, rsteps.param_shardings(mesh, model, ps)),
             (opt, rsteps.opt_shardings(mesh, model, ps)),
             (bspec, rsteps.batch_shardings(mesh, cfg, bspec))]
    total = 0
    for leaves, shards in trees:
        leaves, shards = flat(leaves), flat(shards)
        for k, leaf in leaves.items():
            total += math.prod(shards[k].shard_shape(leaf.shape)) * \\
                np.dtype(leaf.dtype).itemsize
    out[f"args/{arch}/{multi}"] = total
json.dump(out, open(sys.argv[1], "w"))
"""

PORT = COMMON + """
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor._utils import \\
    compute_local_shape_and_global_offset
from repro_torch.configs import get_config
from repro_torch.configs.base import SHAPES
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.model import LM
from repro_torch.runtime import steps

for arch in FLOP_CELLS:
    rec = dryrun.run_cell(arch, "train_4k", mesh_shape=(2, 4), smoke=True,
                          save=False, verbose=False, **SMOKE)
    out["flops/" + arch] = rec["flops"]

for name, (shape, names) in MESHES.items():
    for rank in range(math.prod(shape)):
        dryrun.init_fake_group(math.prod(shape), rank)
        mesh = init_device_mesh("cpu", shape, mesh_dim_names=names)
        for arch in OFFSET_ARCHS:
            model = LM(get_config(arch).smoke(), device="meta", seed=None)
            ps = steps.abstract_params(model)
            for k, (mesh_, pls) in steps.param_shardings(mesh, model,
                                                         ps).items():
                local, off = compute_local_shape_and_global_offset(
                    ps[k][0], mesh_, pls)
                out.setdefault(f"offsets/{name}/{arch}/{k}", []).append(
                    [[o, n] for o, n in zip(off, local)])

for arch, multi in ARG_CELLS:
    dryrun.init_fake_group(512 if multi else 256)
    mesh = make_production_mesh(multi_pod=multi, device_type="cpu")
    with FakeTensorMode():
        _, args = dryrun.abstract_state(get_config(arch), SHAPES["train_4k"],
                                        mesh)
        out[f"args/{arch}/{multi}"] = dryrun.local_bytes(args)
json.dump(out, open(sys.argv[1], "w"))
"""


def _start(script, path, **env):
    e = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
             OMP_NUM_THREADS="1", **env)
    return subprocess.Popen([sys.executable, "-c", textwrap.dedent(script),
                             str(path)], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, env=e,
                            cwd=REPO)


def _finish(proc, path):
    text, _ = proc.communicate(timeout=600)
    assert proc.returncode == 0, text[-6000:]
    with open(path) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """The reference's and the port's results, one subprocess after the
    other (one at a time keeps the load on a shared host low)."""
    tmp = tmp_path_factory.mktemp("dryrun")
    out = []
    for script, name, env in (
            (REFERENCE, "ref.json", dict(
                XLA_FLAGS="--xla_force_host_platform_device_count=8 "
                          "--xla_cpu_multi_thread_eigen=false "
                          "intra_op_parallelism_threads=1",
                JAX_PLATFORMS="cpu")),
            (PORT, "port.json", {})):
        proc = _start(script, tmp / name, **env)
        try:
            out.append(_finish(proc, tmp / name))
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return tuple(out)


def test_cli_writes_a_record_with_the_reference_fields():
    from repro_torch.launch import dryrun

    name = dryrun.artifact_name("mesh2x4", "llama3.2-3b", "train_4k")
    path = os.path.join(dryrun.ARTIFACTS, name)
    bench = os.path.join(REPO, "benchmarks", "artifacts")
    before = set(os.listdir(bench)) if os.path.isdir(bench) else set()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "llama3.2-3b", "--shape", "train_4k", "--smoke", "--mesh", "2x4",
         "--batch", "8", "--seq", "64"], capture_output=True, text=True,
        cwd=REPO, timeout=300,
        env=dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
                 OMP_NUM_THREADS="1"))
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    rec = json.loads(proc.stdout.strip().splitlines()[-1])
    with open(path) as f:
        saved = json.load(f)
    os.remove(path)
    assert rec["path"] == path and path.startswith(
        os.path.join(REPO, "artifacts_torch") + os.sep)
    after = set(os.listdir(bench)) if os.path.isdir(bench) else set()
    assert after == before
    for key in ("arch", "shape", "mesh", "chips", "remat", "flops",
                "dot_bytes", "collective_bytes", "collective_counts",
                "memory", "lower_s", "trace_s"):
        assert key in saved, key
    assert set(saved["memory"]) == {"argument_bytes", "output_bytes",
                                    "temp_bytes", "peak_bytes"}
    assert set(saved["collective_bytes"]) == {
        "all-gather", "all-reduce", "reduce-scatter", "all-to-all",
        "collective-permute"}
    assert saved["chips"] == 8 and saved["mesh"] == "mesh2x4"
    assert saved["flops"] > 0 and saved["memory"]["peak_bytes"] >= \
        saved["memory"]["argument_bytes"] > 0
    assert sum(saved["collective_counts"].values()) > 0


@pytest.mark.parametrize("mesh", list(MESHES))
def test_shard_offsets_match_reference(both, mesh):
    ref, port = both
    keys = {k for k in ref if k.startswith(f"offsets/{mesh}/")}
    assert keys == {k for k in port if k.startswith(f"offsets/{mesh}/")}
    assert len(keys) > 20
    for k in keys:
        assert port[k] == ref[k], k


@pytest.mark.parametrize("arch,multi", ARG_CELLS)
def test_argument_bytes_match_reference(both, arch, multi):
    ref, port = both
    key = f"args/{arch}/{multi}"
    assert port[key] == ref[key] > 0


@pytest.mark.parametrize("arch", FLOP_CELLS[:2])
def test_flops_match_reference(both, arch):
    ref, port = both
    ratio = port[f"flops/{arch}"] / ref[f"flops/{arch}"]
    print(arch, port[f"flops/{arch}"], ref[f"flops/{arch}"], ratio)
    assert 0.95 <= ratio <= 1.1, ratio


def test_moe_flops_gap_is_pinned(both):
    ref, port = both
    arch = FLOP_CELLS[2]
    ratio = port[f"flops/{arch}"] / ref[f"flops/{arch}"]
    print(arch, port[f"flops/{arch}"], ref[f"flops/{arch}"], ratio)
    assert abs(ratio - 1.261) <= 0.02, ratio
