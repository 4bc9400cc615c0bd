"""The port's PlanStore (``repro_torch.core.planstore``, a copy of the
reference's): the artifact lifecycle cases of ``tests/test_planstore.py``
run through the port's store; plans loaded from it equal the reference's
own builds; calibration artifacts (plain data) read across the packages
both ways; and a plan artifact the *reference* wrote raises
``StalePlanError`` in the port, its ``repro`` classes never unpickled."""

import os
import pickle

import pytest

from repro.core import planstore as RS
from repro.core import topology as RT
from repro.core.intersection import ConflictModel as RefCM
from repro.device import CalibratedCost as RefCost
from repro_torch.core import planstore as PS
from repro_torch.core import topology as T
from repro_torch.core.bbs import broadcast_time, build_plan
from repro_torch.core.intersection import ALL_PORT, FULL_DUPLEX, ConflictModel
from repro_torch.core.planstore import (SCHEMA_VERSION, BaselineKey,
                                        CalibrationKey, PackedPlanKey,
                                        PlanKey, PlanStore, StalePlanError)
from repro_torch.device import CalibratedCost


@pytest.fixture(scope="module")
def mesh():
    return T.mesh2d(4, 8)


@pytest.fixture(scope="module")
def mesh_plan(mesh):
    return build_plan(mesh, root=0)


@pytest.fixture(scope="module")
def ref_plans(tmp_path_factory):
    """The reference's plans for roots 0, 5 and 9 through its own packed
    store: a root off its orbit's representative is relabeled there too."""
    plans, _, _ = RS.PlanStore(str(tmp_path_factory.mktemp("ref"))) \
        .get_or_build_packed(RT.mesh2d(4, 8), roots=[0, 5, 9])
    return plans


def assert_plan_equals_reference(plan, ref):
    assert plan.root == ref.root
    assert [c.name for c in plan.candidates] == \
        [c.name for c in ref.candidates]
    for c, rc in zip(plan.candidates, ref.candidates):
        assert (c.a_hat, c.b_hat) == (rc.a_hat, rc.b_hat), rc.name
    assert (plan.L, plan.B) == (ref.L, ref.B)
    for nbytes in (64e3, 1e6, 16e6):
        assert [(c.name, m) for c, m in plan.select(nbytes)] == \
            [(c.name, m) for c, m in ref.select(nbytes)]


def test_store_load_round_trip(tmp_path, mesh, mesh_plan, ref_plans):
    store = PlanStore(str(tmp_path))
    key = PlanKey.for_topology(mesh, root=0)
    assert key.digest() == RS.PlanKey.for_topology(RT.mesh2d(4, 8),
                                                   root=0).digest()
    path = store.store(key, mesh_plan, build_seconds=1.25)
    assert os.path.exists(path)
    loaded, meta = PlanStore(str(tmp_path)).load(key)
    assert meta["build_seconds"] == 1.25
    assert meta["schema"] == SCHEMA_VERSION == RS.SCHEMA_VERSION
    for cand in loaded.candidates:
        assert "_flat_tasks" in cand.pipeline.__dict__
    assert_plan_equals_reference(loaded, ref_plans[0])
    assert broadcast_time(loaded, 1e6) == broadcast_time(mesh_plan, 1e6)


def test_get_or_build_caches(tmp_path, mesh, ref_plans):
    store = PlanStore(str(tmp_path))
    plan, build_s, cached = store.get_or_build(mesh, root=0)
    assert not cached and build_s > 0
    plan2, _, cached2 = store.get_or_build(mesh, root=0)
    assert cached2 and plan2 is plan
    plan3, build_s3, cached3 = PlanStore(str(tmp_path)).get_or_build(
        mesh, root=0)
    assert cached3 and build_s3 == pytest.approx(build_s)
    assert_plan_equals_reference(plan3, ref_plans[0])


def test_get_or_build_hierarchical_pickles(tmp_path):
    store = PlanStore(str(tmp_path))
    _, _, cached = store.get_or_build(T.fat_tree(32, radix=8), root=0)
    assert not cached
    _, _, cached2 = PlanStore(str(tmp_path)).get_or_build(
        T.fat_tree(32, radix=8), root=0)
    assert cached2


@pytest.mark.parametrize("drift", ["schema", "fingerprint", "root", "mode"])
def test_stale_keys_raise(tmp_path, mesh, mesh_plan, drift):
    store = PlanStore(str(tmp_path))
    key = PlanKey.for_topology(mesh, root=0)
    path = store.store(key, mesh_plan)
    other = {"fingerprint": PlanKey.for_topology(T.ring(16), root=0),
             "root": PlanKey.for_topology(mesh, root=1),
             "mode": PlanKey.for_topology(mesh, root=0, mode=ALL_PORT)}
    if drift == "schema":
        blob = pickle.load(open(path, "rb"))
        blob["header"]["schema"] = SCHEMA_VERSION + 1
        pickle.dump(blob, open(path, "wb"))
        with pytest.raises(StalePlanError, match="schema version"):
            PlanStore.load_path(path)
    else:
        with pytest.raises(StalePlanError, match=f"{drift} mismatch"):
            PlanStore.load_path(path, other[drift])


@pytest.mark.parametrize("content", ["truncated", "garbage", "legacy"])
def test_unreadable_artifacts_raise_and_rebuild(tmp_path, mesh, mesh_plan,
                                                content):
    store = PlanStore(str(tmp_path))
    key = PlanKey.for_topology(mesh, root=0)
    path = store.store(key, mesh_plan)
    blob = open(path, "rb").read()
    with open(path, "wb") as f:
        if content == "truncated":                  # a killed writer
            f.write(blob[:len(blob) // 2])
        elif content == "garbage":
            f.write(b"\x00garbage not a pickle\xff" * 64)
        else:                                       # a raw (plan, s) pickle
            pickle.dump((mesh_plan, 0.1), f)
    with pytest.raises(StalePlanError):
        store.load(key)
    plan, _, cached = PlanStore(str(tmp_path)).get_or_build(mesh, root=0)
    assert not cached and plan.root == 0
    assert store.load(key)[0].root == 0          # overwritten, valid again
    assert [f for f in os.listdir(tmp_path) if f.endswith(".tmp")] == []


def test_missing_artifact_is_filenotfound(tmp_path, mesh):
    store = PlanStore(str(tmp_path))
    with pytest.raises(FileNotFoundError):
        store.load(PlanKey.for_topology(mesh, root=0))
    with pytest.raises(FileNotFoundError):
        store.load_baseline(BaselineKey.for_topology(mesh, "srda", 0, 1e6))
    with pytest.raises(FileNotFoundError):
        store.load_calibration(CalibrationKey.for_topology(mesh, "cuda", 32))


def test_packed_round_trip_orbits_and_reference_plans(tmp_path, mesh,
                                                      ref_plans):
    calls = []

    def builder(topo, root=0, mode=FULL_DUPLEX, cm=None):
        calls.append(root)
        return build_plan(topo, root=root, mode=mode, cm=cm)

    store = PlanStore(str(tmp_path))
    plans, build_s, cached = store.get_or_build_packed(mesh, roots=[0, 5],
                                                       builder=builder)
    assert cached == 0 and set(plans) == {0, 5} and build_s > 0
    assert [f for f in os.listdir(tmp_path) if "multiroot" in f] == \
        [PackedPlanKey.for_topology(mesh).filename()]
    plans2, _, cached2 = PlanStore(str(tmp_path)).get_or_build_packed(
        mesh, roots=[0, 5, 9], builder=builder)
    assert cached2 == 2 and set(plans2) == {0, 5, 9}
    aut = mesh.automorphisms()
    canon = {aut.canonical_root(r) for r in (0, 5, 9)}
    assert sorted(calls) == sorted(canon)       # one build per orbit
    for r in (0, 5, 9):
        assert_plan_equals_reference(plans2[r], ref_plans[r])


def test_packed_validation_rebuilds_stale(tmp_path, mesh):
    store = PlanStore(str(tmp_path))
    store.get_or_build_packed(mesh, roots=[0])
    key = PackedPlanKey.for_topology(mesh)
    path = store.path_for_packed(key)
    blob = pickle.load(open(path, "rb"))
    blob["header"]["schema"] = SCHEMA_VERSION + 1
    pickle.dump(blob, open(path, "wb"))
    with pytest.raises(StalePlanError, match="schema version"):
        store.load_packed(key)
    plans, _, cached = PlanStore(str(tmp_path)).get_or_build_packed(
        mesh, roots=[0])
    assert cached == 0 and 0 in plans
    other = PackedPlanKey.for_topology(T.ring(16))
    os.replace(store.path_for_packed(key), store.path_for_packed(other))
    with pytest.raises(StalePlanError, match="fingerprint mismatch"):
        PlanStore(str(tmp_path)).load_packed(other)
    assert PackedPlanKey.for_topology(mesh, mode=ALL_PORT).digest() != \
        key.digest()


def test_baseline_artifacts(tmp_path, mesh):
    """A stored lowering reloads unbound, rebinds and replays like the
    reference's simulation; stale ones raise and rebuild in place."""
    from repro.core.baselines import simulate_baseline as ref_simulate
    from repro_torch.core.baselines import simulate_baseline
    from repro_torch.core.fastsim import CompiledSim

    rtopo = RT.mesh2d(4, 8)
    ref = ref_simulate(rtopo, RefCM(rtopo), "srda", 0, 3.2e6)
    store = PlanStore(str(tmp_path))
    cm = ConflictModel(mesh, FULL_DUPLEX)
    got = simulate_baseline(mesh, cm, "srda", 0, 3.2e6, store=store)
    assert got.finish_time == ref.finish_time
    assert got.deliveries == ref.deliveries
    key = BaselineKey.for_topology(mesh, "srda", 0, 3.2e6)
    store2 = PlanStore(str(tmp_path))
    cm2 = ConflictModel(mesh, FULL_DUPLEX)
    lowered = store2.get_or_lower_baseline(mesh, cm2, "srda", 0, 3.2e6)
    assert lowered.res_ids is None
    res = CompiledSim(mesh, cm2, 0).run_lowered(lowered)
    assert res.node_finish == ref.node_finish
    assert store2.get_or_lower_baseline(mesh, cm2, "srda", 0, 3.2e6) \
        is lowered

    path = store.path_for_baseline(key)
    blob = pickle.load(open(path, "rb"))
    blob["header"]["algo"] = "bine"
    pickle.dump(blob, open(path, "wb"))
    with pytest.raises(StalePlanError, match="algo mismatch"):
        PlanStore(str(tmp_path)).load_baseline(key)
    rebuilt = PlanStore(str(tmp_path)).get_or_lower_baseline(
        mesh, cm, "srda", 0, 3.2e6)
    assert rebuilt.n > 0
    PlanStore(str(tmp_path)).load_baseline(key)      # valid again


def test_calibration_artifacts_read_across_packages(tmp_path):
    """``bbs-calibration`` artifacts hold only plain data: each package
    reads what the other stored, under the same file name."""
    topo, rtopo = T.ring(8), RT.ring(8)
    pkey = CalibrationKey.for_topology(topo, "cuda", 8)
    rkey = RS.CalibrationKey.for_topology(rtopo, "cuda", 8)
    assert pkey.filename() == rkey.filename()
    port_dir, ref_dir = str(tmp_path / "port"), str(tmp_path / "ref")
    cost = CalibratedCost(classes={"tpu_ici": (2e-6, 6e11)},
                          meta={"backend": "cuda", "device_name": "card"})
    PlanStore(port_dir).store_calibration(pkey, cost)
    got, meta = RS.PlanStore(port_dir).load_calibration(rkey)
    assert isinstance(got, RefCost) and got.classes == cost.classes
    assert meta["num_devices"] == 8
    rcost = RefCost(classes={"tpu_ici": (1e-5, 5e10)},
                    meta={"backend": "cuda"})
    RS.PlanStore(ref_dir).store_calibration(rkey, rcost)
    back, _ = PlanStore(ref_dir).load_calibration(pkey)
    assert isinstance(back, CalibratedCost)
    assert (back.classes, back.meta) == (rcost.classes, rcost.meta)
    assert PlanStore(ref_dir).prune() == []
    with pytest.raises(FileNotFoundError):
        PlanStore(port_dir).load_calibration(
            CalibrationKey.for_topology(topo, "cpu", 8))
    path = PlanStore(port_dir).path_for_calibration(pkey)
    open(path, "wb").write(b"garbage")
    with pytest.raises(StalePlanError):
        PlanStore(port_dir).load_calibration(pkey)
    assert PlanStore(port_dir).prune() == [path]


def test_reference_plan_artifacts_are_stale_in_the_port(tmp_path, mesh):
    """The reference writes the same file names, but its plan pickles name
    ``repro.core`` classes: the port's unpickler refuses them before a
    class is looked up, and the store rebuilds in the port's classes."""
    rstore = RS.PlanStore(str(tmp_path))
    rtopo = RT.mesh2d(4, 8)
    rstore.get_or_build(rtopo, root=0)
    rstore.get_or_build_packed(rtopo, roots=[0])
    rstore.get_or_lower_baseline(rtopo, RefCM(rtopo), "bine", 0, 1e6)
    store = PlanStore(str(tmp_path))
    key = PlanKey.for_topology(mesh, root=0)
    assert os.path.exists(store.path_for(key))
    with pytest.raises(StalePlanError, match="outside the port"):
        store.load(key)
    with pytest.raises(StalePlanError, match="outside the port"):
        store.load_packed(PackedPlanKey.for_topology(mesh))
    with pytest.raises(StalePlanError, match="outside the port"):
        store.load_baseline(BaselineKey.for_topology(mesh, "bine", 0, 1e6))
    plan, _, cached = store.get_or_build(mesh, root=0)
    assert not cached and type(plan).__module__ == "repro_torch.core.bbs"
    assert type(store.load(key)[0]).__module__ == "repro_torch.core.bbs"


def test_unpickler_admits_only_port_and_plain_classes(tmp_path):
    """A blob naming any other module raises before that module's object
    is resolved, so nothing it names runs."""
    path = str(tmp_path / "evil.pkl")

    class Call:
        def __reduce__(self):
            return (os.remove, (path,))

    pickle.dump({"magic": "bbs-plan", "x": Call()}, open(path, "wb"))
    with pytest.raises(StalePlanError, match="remove"):
        PS._load_blob(path)
    assert os.path.exists(path)
    import collections
    import numpy as np
    ok = {"a": np.arange(3), "b": collections.OrderedDict(x=1),
          "c": (1.5, "s", None), "d": CalibrationKey("f", "cuda", 8)}
    pickle.dump(ok, open(path, "wb"))
    back = PS._load_blob(path)
    assert back["d"] == ok["d"] and (back["a"] == ok["a"]).all()


def test_prune_removes_stale_artifacts(tmp_path, mesh, mesh_plan):
    store = PlanStore(str(tmp_path))
    good = store.store(PlanKey.for_topology(mesh, root=0), mesh_plan)
    d = str(tmp_path)
    open(os.path.join(d, "interrupted.pkl.tmp"), "wb").write(b"half")
    open(os.path.join(d, "garbage.pkl"), "wb").write(b"\x00not a pickle")
    open(os.path.join(d, "renamed-copy.pkl"), "wb").write(
        open(good, "rb").read())
    blob = pickle.load(open(good, "rb"))
    blob["header"]["schema"] = SCHEMA_VERSION - 1
    pickle.dump(blob, open(os.path.join(d, "old-schema.pkl"), "wb"))
    open(os.path.join(d, "README.txt"), "w").write("left alone")
    removed = store.prune()
    assert sorted(os.path.basename(p) for p in removed) == \
        ["garbage.pkl", "interrupted.pkl.tmp", "old-schema.pkl",
         "renamed-copy.pkl"]
    assert os.path.exists(good)
    assert os.path.exists(os.path.join(d, "README.txt"))
    assert store.prune() == []
