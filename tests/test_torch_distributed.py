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
"""

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
        for what, call in (
                ("cuda_in_gloo", lambda: D.bbs_broadcast(
                    x, ex.schedule, ex.num_groups, device="cuda")),
                ("wrong_size", lambda: ex4.run(x, group=dist.group.WORLD))):
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


@pytest.mark.parametrize("what,match", [("cuda_in_gloo", "gloo"),
                                        ("wrong_size", "group has 8 ranks")])
def test_refusals(ranks, what, match):
    for r in range(WORLD):
        with open(ranks / f"errors.{r}.json") as f:
            msg = json.load(f)[what]
        assert msg is not None and match in msg, (r, msg)
