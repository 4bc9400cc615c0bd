"""Multi-pod dry-run: trace every (arch x shape x mesh) cell on a fake mesh.

    python -m repro_torch.launch.dryrun --arch llama3.2-3b --shape train_4k
    python -m repro_torch.launch.dryrun --arch mamba2-370m --shape train_4k \\
        --multi-pod
    python -m repro_torch.launch.dryrun --all       # full single+multi sweep
    python -m repro_torch.launch.dryrun --arch llama3.2-3b --shape train_4k \\
        --smoke --mesh 2x4 --seq 64 --batch 8

The port of ``repro.launch.dryrun``. The reference lowers and compiles each
cell's train, prefill or decode step for 256 or 512 placeholder devices
and reads XLA's memory and cost analyses. Here the process joins a
``fake`` process group of ``prod(mesh)`` ranks (as rank 0, or ``--rank``),
builds the production mesh over it (``launch.mesh``), and traces the same
step once on DTensors whose local shards are fake tensors
(``FakeTensorMode``): nothing is allocated, no collective runs, and the
ops are those one rank would run. The mesh's device type is ``cpu``: on a
host without CUDA, fake ``cuda`` tensors fail in indexing ops. DTensor
then moves a shard from one dim to another by an all-gather and a chunk
where it would use an all-to-all on NCCL, so such a move counts under
``all-gather``. Each cell records, per device:

  * ``flops``, ``dot_bytes``, ``collective_bytes`` and
    ``collective_counts``: ``runtime.cost.CostMode`` over the step;
  * ``memory.argument_bytes``: the local bytes of the step's arguments
    (params, AdamW's moments and step, the batch; prefill: params and
    batch; decode: params, cache and tokens), from the shards' shapes;
  * ``memory.output_bytes``: the local bytes of what the step returns
    (the train step updates params and moments in place and returns them:
    they count here as well, as XLA counts undonated outputs);
  * ``memory.peak_bytes``: the arguments plus the peak of what the step
    allocates while it runs, from ``MemTracker`` under the fake mode (its
    ``Total``: activations, gradients, temporaries and the optimizer's
    float32 passes; every tensor the local ops create, until it is freed);
    ``memory.temp_bytes`` is that peak less the arguments;
  * ``lower_s``: building and placing the abstract state; ``trace_s``:
    tracing the step (``compile_s`` in the reference).

Records go to ``torch_dryrun_<mesh>_<arch>_<shape>.json`` under
``ARTIFACTS`` (the port's own ``artifacts_torch/``, which ``.gitignore``
lists), never to ``benchmarks/artifacts/``. The fake process group is
global state of the process, so this runs as a program of its own (or in
a subprocess), never inside a test process.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import time
import traceback
from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs import ARCHS, cells, get_config, skipped_cells
from repro_torch.configs.base import SHAPES, ShapeCell
from repro_torch.data.pipeline import make_batch_specs
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.model import LM
from repro_torch.runtime import steps as rsteps
from repro_torch.runtime.cost import CostMode

ARTIFACTS = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__))))), "artifacts_torch")


def mesh_name(shape: Tuple[int, ...]) -> str:
    return {(16, 16): "pod16x16", (2, 16, 16): "pod2x16x16"}.get(
        tuple(shape), "mesh" + "x".join(map(str, shape)))


def mesh_axes_of(shape: Tuple[int, ...]) -> Tuple[str, ...]:
    return ("pod", "data", "model")[-len(shape):]


def input_specs(cfg, cell: ShapeCell) -> Dict:
    """``(shape, dtype)`` stand-ins for every model input of a cell."""
    if cell.kind in ("train", "prefill"):
        return dict(batch=make_batch_specs(cfg, cell))
    toks = make_batch_specs(cfg, cell, for_decode=True)
    enc_len = 4096 if cfg.family == "encdec" else 0
    cache = rsteps.abstract_cache(LM(cfg, device="meta", seed=None),
                                  cell.global_batch, cell.seq_len,
                                  enc_len=enc_len)
    return dict(tokens=toks["tokens"], cache=cache)


def local_bytes(tree) -> int:
    """The bytes of this rank's shards of every tensor in ``tree`` (dicts,
    tuples, lists), each storage counted once."""
    total, seen = 0, set()
    for t in _leaves(tree):
        local = t.to_local() if hasattr(t, "to_local") else t
        key = id(local.untyped_storage())
        if key not in seen:
            seen.add(key)
            total += local.numel() * local.element_size()
    return total


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _leaves(v)
    elif isinstance(tree, torch.Tensor):
        yield tree


def abstract_state(cfg, cell: ShapeCell, mesh, remat: str = "none"):
    """The cell's step and its arguments on ``mesh``, placed by the rules,
    every shard an empty tensor: ``(run, args)``, ``run()`` taking one step
    (``remat`` for a train cell, as in the reference). Call it under
    ``FakeTensorMode``: then nothing is allocated."""
    specs = input_specs(cfg, cell)
    model = LM(cfg, device="meta", seed=None,
               remat=remat if cell.kind == "train" else "none")
    pshape = rsteps.abstract_params(model)
    params = rsteps.place_params(
        model, rsteps.param_shardings(mesh, model, pshape), abstract=True)

    def placed(tree, shardings):
        return rsteps.place(tree, shardings, abstract=True)

    if cell.kind in ("train", "prefill"):
        batch = placed(specs["batch"],
                       rsteps.batch_shardings(mesh, cfg, specs["batch"]))
    if cell.kind == "train":
        step = rsteps.make_train_step(model)
        opt = placed(rsteps.abstract_opt(pshape),
                     rsteps.opt_shardings(mesh, model, pshape))
        return (lambda: step(params, opt, batch)), (params, opt, batch)
    if cell.kind == "prefill":
        fn = rsteps.make_serve_prefill(model)

        def prefill():
            with torch.no_grad():
                return fn(batch)

        return prefill, (params, batch)
    cache = placed(specs["cache"], rsteps.cache_shardings(
        mesh, model, specs["cache"], cell.global_batch == 1))
    tokens = dict(tokens=specs["tokens"])
    toks = placed(tokens, rsteps.batch_shardings(mesh, cfg, tokens))
    fn = rsteps.make_serve_step(model)

    def decode():
        with torch.no_grad():
            return fn(cache, toks["tokens"])

    return decode, (params, cache, toks)


def lower_cell(cfg, cell: ShapeCell, mesh, remat: str = "none") -> Dict:
    """Trace one cell's step on ``mesh`` (a ``DeviceMesh`` over the fake
    process group) under ``FakeTensorMode``; returns the record's cost and
    memory fields and the times."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed._tools.mem_tracker import MemTracker

    t0 = time.perf_counter()
    with FakeTensorMode():
        run, args = abstract_state(cfg, cell, mesh, remat)
        lower_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        cm = CostMode()
        mt = MemTracker()
        with cm, mt:
            out = run()
        trace_s = time.perf_counter() - t0
        arg_b = local_bytes(args)
        snap = mt.get_tracker_snapshot("peak")
        step_peak = max((v.get("Total", 0) for v in snap.values()),
                        default=0)
        out_b = local_bytes(out)
    hc = cm.cost
    return dict(
        flops=hc.flops, dot_bytes=hc.dot_bytes,
        collective_bytes=hc.collective_bytes,
        collective_counts=hc.collective_counts,
        memory=dict(argument_bytes=arg_b, output_bytes=out_b,
                    temp_bytes=step_peak, peak_bytes=arg_b + step_peak),
        lower_s=lower_s, trace_s=trace_s)


def init_fake_group(world: int, rank: int = 0) -> None:
    """Join a ``fake`` process group of ``world`` ranks as ``rank``: no
    other process exists, and a collective moves nothing."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world)


def run_cell(arch: str, shape: str, multi_pod: bool = False,
             remat: str = "none", save: bool = True, verbose: bool = True,
             mesh_shape: Optional[Tuple[int, ...]] = None,
             smoke: bool = False, batch: Optional[int] = None,
             seq: Optional[int] = None, rank: int = 0) -> Dict:
    """Dry-run one cell (module docstring) and return its record."""
    from torch.distributed.device_mesh import init_device_mesh

    cfg = get_config(arch)
    if smoke:
        cfg = cfg.smoke()
    cell = SHAPES[shape]
    if batch or seq:
        cell = ShapeCell(cell.name, cell.kind, seq or cell.seq_len,
                         batch or cell.global_batch)
    if mesh_shape is None:
        mesh_shape = (2, 16, 16) if multi_pod else (16, 16)
    name = mesh_name(mesh_shape)
    init_fake_group(math.prod(mesh_shape), rank)
    if tuple(mesh_shape) in ((16, 16), (2, 16, 16)):
        mesh = make_production_mesh(multi_pod=len(mesh_shape) == 3,
                                    device_type="cpu")
    else:
        mesh = init_device_mesh("cpu", tuple(mesh_shape),
                                mesh_dim_names=mesh_axes_of(mesh_shape))
    rec = dict(arch=arch, shape=shape, mesh=name,
               chips=math.prod(mesh_shape), rank=rank, remat=remat,
               config=cfg.name, global_batch=cell.global_batch,
               seq_len=cell.seq_len, **lower_cell(cfg, cell, mesh, remat))
    if verbose:
        gb = rec["memory"]["peak_bytes"] / 2 ** 30
        print(f"[{name}] {arch:24s} {shape:12s} flops={rec['flops']:.3e} "
              f"dotB={rec['dot_bytes']:.3e} "
              f"coll={sum(rec['collective_bytes'].values()):.3e}B "
              f"peak={gb:.2f}GiB (lower {rec['lower_s']:.1f}s trace "
              f"{rec['trace_s']:.1f}s)", flush=True)
    if save:
        os.makedirs(ARTIFACTS, exist_ok=True)
        path = os.path.join(ARTIFACTS, artifact_name(name, arch, shape))
        with open(path, "w") as f:
            json.dump(rec, f, indent=1)
        rec["path"] = path
    return rec


def artifact_name(mesh: str, arch: str, shape: str) -> str:
    return f"torch_dryrun_{mesh}_{arch}_{shape}.json"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCHS)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--remat", default="none", choices=["none", "dots"])
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--mesh", help="another mesh than the production one, "
                    "e.g. 2x4 (data x model) or 2x2x2 (pod x data x model)")
    ap.add_argument("--smoke", action="store_true",
                    help="the arch's reduced config")
    ap.add_argument("--batch", type=int, help="global batch in place of "
                    "the cell's")
    ap.add_argument("--seq", type=int, help="sequence in place of the "
                    "cell's")
    ap.add_argument("--rank", type=int, default=0,
                    help="the rank whose shards and ops are traced")
    args = ap.parse_args(argv)
    mesh_shape = tuple(int(x) for x in args.mesh.split("x")) \
        if args.mesh else None

    if args.all:
        failures = []
        for multi in (False, True):
            for arch in ARCHS:
                for shape in cells(arch):
                    name = "pod2x16x16" if multi else "pod16x16"
                    path = os.path.join(ARTIFACTS,
                                        artifact_name(name, arch, shape))
                    if args.skip_existing and os.path.exists(path):
                        print(f"skip {name} {arch} {shape}", flush=True)
                        continue
                    try:
                        run_cell(arch, shape, multi, remat=args.remat)
                    except Exception as e:   # noqa: BLE001 -- the sweep
                        failures.append((name, arch, shape, repr(e)))
                        print(f"FAIL [{name}] {arch} {shape}: {e}",
                              flush=True)
                        traceback.print_exc()
                for shape in skipped_cells(arch):
                    print(f"SKIP(noted) {arch} {shape}: dense-attention "
                          f"arch, see DESIGN.md §Arch-applicability",
                          flush=True)
        print(f"\ndry-run sweep complete; failures: {len(failures)}")
        for f in failures:
            print("  FAIL", *f)
        raise SystemExit(1 if failures else 0)

    if not (args.arch and args.shape):
        ap.error("--arch and --shape are needed without --all")
    rec = run_cell(args.arch, args.shape, args.multi_pod, remat=args.remat,
                   mesh_shape=mesh_shape, smoke=args.smoke,
                   batch=args.batch, seq=args.seq, rank=args.rank)
    print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
