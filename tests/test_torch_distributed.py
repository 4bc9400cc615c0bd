"""The distributed executor (``repro_torch.device.distributed``) against the
virtual-mesh runner: eight gloo ranks on the CPU, one process each.

Each rank holds only its own packet buffer and exchanges rows with
``batch_isend_irecv``; every rank's copy must equal, byte for byte, that
device's copy from the virtual mesh (``ExecutablePlan.run`` with no group),
which ``tests/test_torch_slice.py`` holds to the reference's shard_map
runner. Cases: the ring 8 and hypercube 3 BBS plans from roots 0 and 3, a
bfloat16 payload, the binomial and chain runners, a 4-device plan on each
of two 4-rank subgroups (global ranks differ from group ranks), and the
refusals: a CUDA buffer in a gloo group, a group of the wrong size. One
spawn of eight processes (a ``FileStore`` under ``tmp_path``) runs every
case within a 120 s timeout. Tolerance: exact.

The same spawn holds the calibration across the group
(``repro_torch.device.calibrate`` with ``group=``) at smoke size (ring 8,
1 KiB and 8 KiB, ``iters`` 4, ``reps`` 2): ``measure_round``,
``calibrate``, ``ExecutablePlan.measure`` and ``prediction_report`` give
the same values on every rank; the ring delivers; the artifact's meta has
the reference's keys and says what was measured (``"cpu-gloo"``,
emulated, 8 ranks); its ``CalibrationKey`` is not the virtual mesh's; the
predicted side is ``predict_cycle_time``'s; a group of the wrong size
raises. Times are CPU times of the plain round step, held to no bound.
The ``"pipeline"`` baseline, which the port lowers as its chain tree with
its packets as groups, is held across the ranks and on the virtual mesh.
"""

import importlib
import json
import multiprocessing as mp
import os
import time

import numpy as np
import pytest
import torch

WORLD = 8
TIMEOUT_S = 120
BBS = [("ring8", 0), ("ring8", 3), ("hypercube3", 0), ("hypercube3", 3)]
CAL_SIZES = (1 << 10, 8 << 10)
CAL_ITERS, CAL_REPS = 4, 2
REPORTED = ["bbs", "binomial", "pipeline"]
# the reference's CalibratedCost meta keys (repro.device.calibrate.calibrate)
REF_META = {"backend", "num_devices", "emulated", "axis", "sizes",
            "round_seconds", "fit_residual_seconds", "iters", "reps"}


def _topo(name, T):
    return {"ring8": lambda: T.ring(8), "hypercube3": lambda: T.hypercube(3),
            "hypercube2": lambda: T.hypercube(2)}[name]()


def _payload(dtype, seed):
    f = np.random.default_rng(seed).standard_normal(1500).astype(np.float32)
    return torch.from_numpy(f).to(getattr(torch, dtype))


def _cpu(dtype="float32"):
    from repro_torch.core.simconfig import DeviceConfig, SimConfig
    return SimConfig(device=DeviceConfig(device="cpu", dtype=dtype))


def _bytes(t):
    return t.contiguous().reshape(-1).view(torch.uint8).numpy()


def _worker(rank, store_path, out_dir):
    """One rank: run every case and save this rank's copies and errors."""
    import torch.distributed as dist

    from repro_torch import api
    from repro_torch.core import topology as T
    from repro_torch.device import distributed as D

    # eight ranks share the host's cores: with torch's default intra-op
    # threads each, OpenMP's idle threads spin between the plain round
    # steps and a sub-round's exchange takes about 200 ms instead of 3
    torch.set_num_threads(1)
    store = dist.FileStore(store_path, WORLD)
    dist.init_process_group("gloo", store=store, rank=rank,
                            world_size=WORLD)
    out, errors = {}, {}
    try:
        for name, root in BBS:
            ex = api.compile(_topo(name, T)).executable(
                root=root, nbytes=6000, config=_cpu())
            x = _payload("float32", root)
            out[f"bbs-{name}-{root}"] = _bytes(ex.run(x, group=dist.group.WORLD))
            chk = ex.verify(x, group=dist.group.WORLD)
            out[f"verify-{name}-{root}"] = np.asarray(
                [chk.ok, len(chk.missing)], dtype=np.uint8)
        ex = api.compile(T.ring(8)).executable(root=3, nbytes=3000,
                                               config=_cpu("bfloat16"))
        out["bbs-bf16"] = _bytes(ex.run(_payload("bfloat16", 7),
                                        group=dist.group.WORLD))
        x = _payload("float32", 11)
        out["binomial"] = _bytes(D.binomial_broadcast(x, WORLD, root=3,
                                                      device="cpu"))
        out["chain"] = _bytes(D.chain_broadcast(x, WORLD, root=3,
                                                num_packets=5, device="cpu"))
        # a 4-device plan on two 4-rank subgroups at once
        halves = [dist.new_group([0, 1, 2, 3]), dist.new_group([4, 5, 6, 7])]
        ex4 = api.compile(T.hypercube(2)).executable(root=1, nbytes=6000,
                                                     config=_cpu())
        out["subgroup"] = _bytes(ex4.run(_payload("float32", 5),
                                         group=halves[rank // 4]))
        _calibrate_on_ranks(rank, out, errors, dist.group.WORLD)
        C = importlib.import_module("repro_torch.device.calibrate")
        for what, call in (
                ("cuda_in_gloo", lambda: D.bbs_broadcast(
                    x, ex.schedule, ex.num_groups, device="cuda")),
                ("wrong_size", lambda: ex4.run(x, group=dist.group.WORLD)),
                ("measure_round_wrong_size", lambda: C.measure_round(
                    4, 1 << 10, device="cpu", group=dist.group.WORLD)),
                ("calibrate_wrong_size", lambda: ex4.calibrate(
                    group=dist.group.WORLD)),
                ("measure_wrong_size", lambda: ex4.measure(
                    group=dist.group.WORLD))):
            try:
                call()
                errors[what] = None
            except ValueError as e:
                errors[what] = str(e)
        for key, val in out.items():
            np.save(os.path.join(out_dir, f"{key}.{rank}.npy"), val)
        with open(os.path.join(out_dir, f"errors.{rank}.json"), "w") as f:
            json.dump(errors, f)
    finally:
        dist.destroy_process_group()


def _calibrate_on_ranks(rank, out, errors, group):
    """The calibration across the group: ``measure_round``, ``calibrate``
    and its keys, and each of ``REPORTED``'s measure and report row on ring
    8; saved into ``out`` (arrays) and ``errors`` (JSON)."""
    from repro_torch import api
    from repro_torch.core import topology as T
    from repro_torch.core.planstore import CalibrationKey
    from repro_torch.device import distributed as D
    C = importlib.import_module("repro_torch.device.calibrate")

    # the ring's delivery check reads each rank's whole buffer: a byte
    # flipped in one rank's staging row, or in its own row 0, fails it on
    # every rank
    prog = D.ring_round_group(1 << 10, group, "cpu", 2)
    flags = []
    for flip in (None, (5, 2), (2, 0)):
        prog.pack()
        D.run(prog)
        if flip is not None and rank == flip[0]:
            prog.buf[0, flip[1], 3] ^= 1
        flags.append(D.ring_delivered_group(prog))
    out["ring_delivered"] = np.asarray(flags)
    out["measure_round"] = np.asarray([C.measure_round(
        WORLD, CAL_SIZES[1], device="cpu", iters=CAL_ITERS, reps=CAL_REPS,
        group=group)])
    topo = T.ring(WORLD)
    cost = C.calibrate(topo, device="cpu", group=group, sizes=CAL_SIZES,
                       iters=CAL_ITERS, reps=CAL_REPS)
    errors["cost"] = cost.to_dict()
    errors["keys"] = [
        CalibrationKey.for_topology(topo, cost.meta["backend"],
                                    WORLD).digest(),
        CalibrationKey.for_topology(topo, "cpu", WORLD).digest()]
    model = api.compile(topo)
    for algo in REPORTED:
        ex = model.executable(root=3, nbytes=6000, algo=algo, config=_cpu())
        t = ex.measure(reps=CAL_REPS, group=group)
        row, = C.prediction_report([ex], cost, reps=CAL_REPS, group=group)
        out[f"report-{algo}"] = np.asarray([
            t, row.measured_cycle_s, row.predicted_cycle_s,
            C.predict_cycle_time(ex, cost), row.num_cycles,
            ex.schedule.num_cycles(ex.num_groups)])
        out[f"copy-{algo}"] = _bytes(ex.run(_payload("float32", 13),
                                            group=group))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Spawn the eight ranks once; the directory of what they saved."""
    tmp = tmp_path_factory.mktemp("dist")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_worker,
                         args=(r, str(tmp / "store"), str(tmp)))
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


def _saved(tmp, key):
    return [np.load(tmp / f"{key}.{r}.npy") for r in range(WORLD)]


def _virtual(name, root, dtype, seed, nbytes=6000):
    from repro_torch import api
    from repro_torch.core import topology as T
    ex = api.compile(_topo(name, T)).executable(root=root, nbytes=nbytes,
                                                config=_cpu(dtype))
    out = ex.run(_payload(dtype, seed))
    return [_bytes(out[v]) for v in range(out.shape[0])]


@pytest.mark.parametrize("name,root", BBS)
def test_bbs_ranks_match_virtual_mesh(ranks, name, root):
    got = _saved(ranks, f"bbs-{name}-{root}")
    want = _virtual(name, root, "float32", root)
    for r in range(WORLD):
        np.testing.assert_array_equal(got[r], want[r], err_msg=f"rank {r}")
    assert all(np.array_equal(g, _bytes(_payload("float32", root)))
               for g in got)
    assert all(v.tolist() == [1, 0]
               for v in _saved(ranks, f"verify-{name}-{root}"))


def test_bf16_payload_matches_virtual_mesh(ranks):
    got = _saved(ranks, "bbs-bf16")
    want = _virtual("ring8", 3, "bfloat16", 7, nbytes=3000)
    for r in range(WORLD):
        np.testing.assert_array_equal(got[r], want[r], err_msg=f"rank {r}")


@pytest.mark.parametrize("algo", ["binomial", "chain"])
def test_baseline_ranks_match_virtual_mesh(ranks, algo):
    from repro_torch.device import runner

    x = _payload("float32", 11)
    if algo == "binomial":
        out = runner.binomial_broadcast(x, WORLD, root=3, device="cpu")
    else:
        out = runner.chain_broadcast(x, WORLD, root=3, num_packets=5,
                                     device="cpu")
    got = _saved(ranks, algo)
    for r in range(WORLD):
        np.testing.assert_array_equal(got[r], _bytes(out[r]),
                                      err_msg=f"rank {r}")
        np.testing.assert_array_equal(got[r], _bytes(x))


def test_subgroups_map_group_ranks_to_global_ranks(ranks):
    got = _saved(ranks, "subgroup")
    want = _virtual("hypercube2", 1, "float32", 5)
    for r in range(WORLD):
        np.testing.assert_array_equal(got[r], want[r % 4],
                                      err_msg=f"rank {r}")


@pytest.mark.parametrize("what,match", [
    ("cuda_in_gloo", "gloo"), ("wrong_size", "group has 8 ranks"),
    ("measure_round_wrong_size", "a ring of 4 devices on a group of 8"),
    ("calibrate_wrong_size", "a ring of 4 devices on a group of 8"),
    ("measure_wrong_size", "group has 8 ranks")])
def test_refusals(ranks, what, match):
    for r in range(WORLD):
        with open(ranks / f"errors.{r}.json") as f:
            msg = json.load(f)[what]
        assert msg is not None and match in msg, (r, msg)


def _costs(tmp):
    out = []
    for r in range(WORLD):
        with open(tmp / f"errors.{r}.json") as f:
            out.append(json.load(f))
    return out


def test_group_measure_round_is_one_float_on_every_rank(ranks):
    """``measure_round(group=)``: the slowest rank's window, the same float
    on all eight ranks, after the ring delivered (it raises otherwise)."""
    got = [float(v[0]) for v in _saved(ranks, "measure_round")]
    assert len(set(got)) == 1 and np.isfinite(got[0]) and got[0] > 0


def test_group_calibrate_meta_says_what_was_measured(ranks):
    """One ``CalibratedCost`` on every rank, with the reference's meta keys
    and the group's: gloo on the CPU is emulated, eight ranks 0..7."""
    from repro_torch.device.calibrate import CalibratedCost, ring_row_bytes

    costs = [CalibratedCost.from_dict(e["cost"]) for e in _costs(ranks)]
    assert all(c == costs[0] for c in costs)
    cost = costs[0]
    (cls, (a, b)), = cost.classes.items()
    assert cls == "tpu_ici" and a >= 0 and b > 0 and np.isfinite([a, b]).all()
    meta = cost.meta
    assert REF_META <= set(meta)
    assert (meta["backend"], meta["emulated"], meta["axis"],
            meta["num_devices"]) == ("cpu-gloo", True, "group", WORLD)
    assert meta["ranks"] == list(range(WORLD))
    assert meta["device_name"] == ["cpu"] * WORLD
    assert meta["sizes"] == list(CAL_SIZES)
    assert meta["row_bytes"] == [ring_row_bytes(s) for s in CAL_SIZES]
    assert (meta["iters"], meta["reps"]) == (CAL_ITERS, CAL_REPS)
    assert len(meta["round_seconds"]) == len(CAL_SIZES)
    assert all(t > 0 for t in meta["round_seconds"])
    assert meta["beta_clamped"] is (b == 1.0 / 1e-18)


def test_group_ring_delivery_reads_every_rank_whole_buffer(ranks):
    """``ring_delivered_group`` holds on the ring as run, and fails on every
    rank when one rank's staging row or its own row 0 has a flipped byte."""
    for v in _saved(ranks, "ring_delivered"):
        np.testing.assert_array_equal(v, [True, False, False])


@pytest.mark.parametrize("name,root", BBS)
def test_rank_tables_are_the_slot_table_columns(name, root):
    """``bbs_tables`` gives each rank its column of ``slot_tables``, every
    cycle's sub-rounds in turn, and sends to the rank its matching pairs it
    with; ``local_writes`` is K1's table of each write (the staging row at
    ``r_ix`` if ``r_ok``, zeros when no one sent)."""
    from repro_torch import api
    from repro_torch.core import topology as T
    from repro_torch.device import distributed as D
    from repro_torch.device.runner import slot_tables

    ex = api.compile(_topo(name, T)).executable(root=root, nbytes=6000,
                                                config=_cpu())
    sched = ex.schedule
    full = slot_tables(sched, ex.num_groups)
    for me in range(WORLD):
        tabs, to = D.bbs_tables(sched, ex.num_groups, me)
        np.testing.assert_array_equal(tabs, full[..., me].reshape(-1, 5))
        for k, dst in enumerate(to):
            pairs = dict(sched.perms[k % sched.d])
            assert dst == pairs.get(me, -1)
        local = D.local_writes(tabs, 7)
        assert local.shape == (len(tabs), 5, 1)
        np.testing.assert_array_equal(local[:, :, 0], np.stack([
            np.zeros(len(tabs)), np.full(len(tabs), 7), tabs[:, 0] >= 0,
            tabs[:, 3], tabs[:, 4]], axis=1))


def test_group_key_is_not_the_virtual_mesh_key(ranks):
    """The group's fit and the virtual mesh's fit of ring 8 are stored
    under different digests: neither overwrites the other."""
    keys = [e["keys"] for e in _costs(ranks)]
    assert all(k == keys[0] for k in keys)
    group_key, virtual_key = keys[0]
    assert group_key != virtual_key


@pytest.mark.parametrize("algo", REPORTED)
def test_group_measure_and_report_equal_on_every_rank(ranks, algo):
    """``ExecutablePlan.measure(group=)`` and ``prediction_report(group=)``
    give one value on every rank; the predicted side is
    ``predict_cycle_time``'s and the row's cycles the schedule's."""
    got = _saved(ranks, f"report-{algo}")
    for v in got:
        np.testing.assert_array_equal(v, got[0])
    t, measured, predicted, want, cycles, sched_cycles = got[0]
    assert t > 0 and measured > 0 and np.isfinite([t, measured]).all()
    assert predicted == want and predicted > 0
    assert cycles == sched_cycles >= 1


@pytest.mark.parametrize("algo", REPORTED)
def test_reported_executables_deliver_across_ranks(ranks, algo):
    """Every rank's copy from the executables the report measured equals
    that device's copy on the virtual mesh and the payload."""
    from repro_torch import api
    from repro_torch.core import topology as T

    ex = api.compile(T.ring(WORLD)).executable(root=3, nbytes=6000,
                                               algo=algo, config=_cpu())
    x = _payload("float32", 13)
    out = ex.run(x)
    got = _saved(ranks, f"copy-{algo}")
    for r in range(WORLD):
        np.testing.assert_array_equal(got[r], _bytes(out[r]),
                                      err_msg=f"rank {r}")
        np.testing.assert_array_equal(got[r], _bytes(x))


@pytest.mark.parametrize("name", ["ring8", "hypercube3"])
def test_pipeline_baseline_lowers_its_chain_with_packets_as_groups(name):
    """``algo="pipeline"`` lowers the baseline's chain tree (rank order from
    the root) with its 64 KiB packets as the pipeline's groups, and
    delivers bit-exact on the virtual mesh; a baseline of block exchanges
    (srda) is still refused."""
    from repro_torch import api
    from repro_torch.core import baselines as B
    from repro_torch.core import topology as T
    from repro_torch.device.schedule import NotDeviceExecutable

    topo = _topo(name, T)
    model = api.compile(topo)
    nbytes = 1 << 20
    ex = model.executable(root=2, nbytes=nbytes, algo="pipeline",
                          config=_cpu())
    tasks = B.BASELINES["pipeline"](topo, 2, nbytes)
    assert ex.candidate == "pipeline" and ex.num_groups == 16 == \
        len({t.blk for t in tasks})
    chain = {t.dst: t.src for t in tasks if t.blk == (0, 1)}
    assert chain == {(2 + i + 1) % 8: (2 + i) % 8 for i in range(7)}
    assert ex.verify(ex.default_payload()).ok
    assert ex.predicted_time == model.simulate_baseline(
        "pipeline", 2, nbytes).finish_time
    with pytest.raises(NotDeviceExecutable, match="whole packets"):
        model.executable(root=2, nbytes=nbytes, algo="srda", config=_cpu())
