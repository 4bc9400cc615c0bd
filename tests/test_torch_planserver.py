"""The port's PlanServer (``repro_torch.launch.planserver``, a copy of the
reference's) on the nine cases of ``tests/test_planserver.py``, with its
``request`` answers exactly equal to the reference server's; the facade's
parity with ``repro.api.CompiledModel``; and an orbit-relabeled plan that
executes bit-exact on the CPU."""

import inspect
import threading

import pytest

from repro import api as ref_api
from repro.core import topology as RT
from repro.launch.planserver import PlanServer as RefServer
from repro_torch import api
from repro_torch.core import topology as T
from repro_torch.core.bbs import broadcast_time, build_plan
from repro_torch.core.planstore import PlanStore
from repro_torch.core.simconfig import DeviceConfig, SimConfig
from repro_torch.launch.planserver import PlanServer, main, run_smoke

CPU = SimConfig(device=DeviceConfig(device="cpu"))


@pytest.fixture(scope="module")
def ring16_plan():
    return build_plan(T.ring(16), root=0)


@pytest.mark.parametrize("fabric,roots", [
    (lambda T: T.ring(16), (0, 7)),
    (lambda T: T.mesh2d(4, 4), (0, 1, 5, 15, 10)),
    (lambda T: T.hypercube(3), (0, 6)),
], ids=["ring16", "mesh2d_4x4", "hypercube3"])
def test_request_answers_equal_reference_server(fabric, roots):
    port, ref = PlanServer(), RefServer()
    pfp, rfp = port.register(fabric(T)), ref.register(fabric(RT))
    assert pfp == rfp
    for root in roots:
        for nbytes in (64e3, 1e6, 16e6):
            assert port.request(pfp, root, nbytes) == \
                ref.request(rfp, root, nbytes), (root, nbytes)
    assert port.stats.as_dict().keys() == ref.stats.as_dict().keys()
    for k in ("requests", "l1_hits", "plan_hits", "relabels", "builds",
              "evictions"):
        assert getattr(port.stats, k) == getattr(ref.stats, k), k


def test_request_answers_match_direct_build(ring16_plan):
    server = PlanServer()
    fp = server.register(T.ring(16))
    for root in (0, 7):
        for nbytes in (1e6, 16e6):
            t, info = server.request(fp, root, nbytes)
            assert t == broadcast_time(ring16_plan, nbytes)[0]
            assert "strategy" in info


def test_orbit_canonicalization_builds_once():
    server = PlanServer()
    topo = T.ring(16)
    fp = server.register(topo)
    n = topo.num_nodes
    for i in range(50):
        server.request(fp, i % n, 1e6)
    st = server.stats
    assert st.builds == 1 and st.relabels == n - 1 and st.requests == 50
    assert st.hit_rate == 1.0 - 1.0 / 50
    assert st.l1_hits == 50 - n


def test_unregistered_fingerprint_rejected():
    with pytest.raises(KeyError, match="register"):
        PlanServer().request("deadbeef", 0, 1e6)


def test_single_flight_dedups_concurrent_builds():
    server = PlanServer()
    fp = server.register(T.ring(8))
    results, errors = [], []
    barrier = threading.Barrier(6)

    def worker(root):
        try:
            barrier.wait(timeout=30)
            results.append(server.plan(fp, root))
        except Exception as exc:   # noqa: BLE001
            errors.append(exc)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert not errors and len(results) == 6
    assert server.stats.builds == 1
    assert sorted(p.root for p in results) == list(range(6))


def test_prefetch_coalesces_and_serves():
    server = PlanServer()
    topo = T.ring(8)
    plans = [f.result(timeout=120)
             for f in [server.prefetch(topo, r) for r in (0, 3, 5)]]
    assert [p.root for p in plans] == [0, 3, 5]
    assert server.stats.builds == 1
    t, _ = server.request(topo, 3, 1e6)
    assert t > 0 and server.stats.builds == 1
    futs = server.prefetch_jobs(topo, [3, 5, 7])
    assert list(futs) == [0]
    assert futs[0].result(timeout=120).root == 0


def test_plan_lru_evicts_and_counts():
    server = PlanServer(plan_capacity=2)
    fp = server.register(T.mesh2d(4, 4))   # 3 orbits: reps 0, 1, 5
    for root in (0, 1, 5):
        server.plan(fp, root)
    assert server.stats.builds == 3 and server.stats.evictions >= 1
    server.plan(fp, 0)
    assert server.stats.builds >= 3


def test_response_lru_bounds_l1():
    server = PlanServer(response_capacity=2)
    fp = server.register(T.ring(8))
    sizes = (1e5, 2e5, 4e5)
    for nbytes in sizes:
        server.request(fp, 0, nbytes)
    before = server.stats.l1_hits
    server.request(fp, 0, sizes[0])        # evicted: recompute, no L1 hit
    assert server.stats.l1_hits == before
    server.request(fp, 0, sizes[2])        # still resident
    assert server.stats.l1_hits == before + 1


def test_store_backed_server_reuses_packed_artifacts(tmp_path):
    server = PlanServer(store=PlanStore(str(tmp_path)))
    t1, _ = server.request(T.ring(8), 5, 1e6)
    assert server.stats.builds == 1
    server2 = PlanServer(store=PlanStore(str(tmp_path)))
    t2, _ = server2.request(T.ring(8), 5, 1e6)
    assert t1 == t2


def test_smoke_entrypoint(capsys):
    st = run_smoke(n=8, requests=40, verbose=False)
    assert st.builds == 1 and st.hit_rate >= 0.9
    assert main(["--smoke", "--n", "8", "--requests", "24"]) == 0
    assert "1 build(s)" in capsys.readouterr().out


def test_facade_has_every_public_name_of_the_reference():
    """Every public method and attribute of ``repro.api.CompiledModel``
    (and ``compile``) exists on the port's, with the same parameters."""
    ref_cls, port_cls = ref_api.CompiledModel, api.CompiledModel
    names = {n for n in dir(ref_cls) if not n.startswith("_")}
    names |= {f for f in ref_cls.__dataclass_fields__}
    for name in sorted(names):
        if name in ref_cls.__dataclass_fields__:
            assert name in port_cls.__dataclass_fields__, name
            continue
        assert hasattr(port_cls, name), name
        ref_attr, port_attr = getattr(ref_cls, name), getattr(port_cls, name)
        if callable(ref_attr):
            assert list(inspect.signature(port_attr).parameters) == \
                list(inspect.signature(ref_attr).parameters), name
    assert list(inspect.signature(api.compile).parameters) == \
        list(inspect.signature(ref_api.compile).parameters)
    model = api.compile(T.ring(8))
    ref = ref_api.compile(RT.ring(8))
    assert model.fingerprint == ref.fingerprint
    assert model.compiled is model.cm.compiled()
    assert model.ensure_server() is model.ensure_server() is model.server


def test_served_model_and_relabeled_executable(tmp_path):
    """``compile(server=True, store=...)``: plans come from the server, a
    root off its orbit's representative by relabeling, and the relabeled
    plan's executable delivers bit-exact on the CPU, with the reference's
    candidate and tables size."""
    model = api.compile(T.mesh2d(3, 3), store=PlanStore(str(tmp_path)))
    ref = ref_api.compile(RT.mesh2d(3, 3), server=True)
    aut = model.topo.automorphisms()
    root = 8
    assert aut.canonical_root(root) != root
    for r in (aut.canonical_root(root), root):
        ex = model.executable(root=r, nbytes=3000, config=CPU)
        rex = ref.executable(root=r, nbytes=3000)
        assert (ex.candidate, ex.num_groups, ex.schedule.d) == \
            (rex.candidate, rex.num_groups, rex.schedule.d)
        assert ex.verify(ex.default_payload(seed=r)).ok
        assert model.broadcast_time(r, 3000) == ref.broadcast_time(r, 3000)
    assert model.server.stats.builds == 1
    assert model.server.stats.relabels == 1
