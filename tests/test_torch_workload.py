"""The port's workload engine (``repro_torch.workload``, a copy of the
reference's) on the cases of ``tests/test_workload.py``: every
``WorkloadReport.to_dict()`` equals the reference's on the same jobs
(seeded Poisson streams, off-orbit roots, deadlines, a load sweep, churn),
the hand-derived two-job contention and queueing times hold exactly, and
the arrival processes give the reference's jobs."""

import dataclasses
import json

import pytest

import repro.workload as RW
import repro_torch.workload as PW
from repro import api as ref_api
from repro.core import faults as RF
from repro.core import topology as RT
from repro_torch import api
from repro_torch.core import faults as F
from repro_torch.core import topology as T
from repro_torch.core.fastsim import CompiledSim, JobSpec
from repro_torch.core.intersection import FULL_DUPLEX, ConflictModel
from repro_torch.core.simconfig import SimConfig
from repro_torch.core.simulator import EventSimulator, SendTask, \
    pipeline_tasks

NBYTES = float(1 << 20)
CORNERS = [0, 7, 56, 63]
PKG = {"port": (api, T, F, PW), "ref": (ref_api, RT, RF, RW)}


@pytest.fixture(scope="module")
def models():
    return {k: a.compile(t.mesh2d(8, 8), server=True)
            for k, (a, t, _, _) in PKG.items()}


def kill_0_1(model, fraction, F_):
    t1, _ = model.broadcast_time(0, NBYTES)
    return t1, F_.FaultSchedule.kill_link(model.topo.links((0, 1))[0],
                                          time=t1 * fraction)


def case_single_job(model, F_, W):
    return [W.run_workload(model, [W.BroadcastJob(0.0, r, NBYTES)])
            for r in (0, 63)]


def case_seeded_poisson(model, F_, W):
    jobs = W.poisson_jobs(rate=2e4, num_jobs=20, roots=CORNERS,
                          nbytes=NBYTES, seed=42)
    return [W.run_workload(model, jobs), W.run_workload(model, jobs)]


def case_deadlines(model, F_, W):
    return [W.run_workload(model, W.poisson_jobs(5e4, 10, [0, 63], NBYTES,
                                                 seed=9, deadline=dl))
            for dl in (1e-12, 10.0)]


def case_load_sweep(model, F_, W):
    base = 1.0 / model.broadcast_time(0, NBYTES)[0]
    return W.offered_load_sweep(model, [0.2 * base, 20 * base, 100 * base],
                                num_jobs=16, roots=CORNERS, nbytes=NBYTES,
                                seed=7)


def case_churn(model, F_, W):
    t1, sched = kill_0_1(model, 1 / 3, F_)
    single = W.run_workload(model, [W.BroadcastJob(0.0, 0, NBYTES)],
                            faults=sched)
    t1, sched = kill_0_1(model, 1 / 2, F_)
    jobs = W.poisson_jobs(1.0 / t1, 6, CORNERS, nbytes=NBYTES, seed=3)
    return [single, W.run_workload(model, jobs, faults=sched)]


def case_repair_at_admission(model, F_, W):
    small = (api if W is PW else ref_api).compile(
        (T if W is PW else RT).mesh2d(2, 2))
    t1, _ = small.broadcast_time(0, 64e3)
    sched = F_.FaultSchedule.kill_link(small.topo.links((0, 1))[0],
                                       time=t1 / 4)
    return [W.run_workload(small, [W.BroadcastJob(0.0, 0, 64e3, job_id=0),
                                   W.BroadcastJob(3 * t1, 0, 64e3,
                                                  job_id=1)],
                           faults=sched)]


CASES = {f.__name__[5:]: f for f in (
    case_single_job, case_seeded_poisson, case_deadlines, case_load_sweep,
    case_churn, case_repair_at_admission)}


@pytest.mark.parametrize("case", list(CASES))
def test_reports_equal_reference(models, case):
    got = {k: CASES[case](models[k], PKG[k][2], PKG[k][3]) for k in PKG}
    port, ref = ([r.to_dict() for r in got[k]] for k in ("port", "ref"))
    assert port == ref
    for rep in got["port"]:
        assert rep.completed == rep.started or rep.faults is not None
        assert all(j.finish >= j.arrival for j in rep.jobs)
        back = PW.WorkloadReport.from_dict(json.loads(json.dumps(
            rep.to_dict())))
        assert back.to_dict() == rep.to_dict()
    if case == "seeded_poisson":
        a, b = got["port"]
        assert a.to_dict() == b.to_dict() and len(a.jobs) == 20
        assert a.latency_p99 >= a.latency_p50 > 0.0
    elif case == "deadlines":
        assert [r.deadline_misses for r in got["port"]] == [10, 0]
    elif case == "load_sweep":
        light, mid, heavy = got["port"]
        assert not light.saturated and heavy.saturated
        assert heavy.jobs_per_s < 2 * mid.jobs_per_s
        assert light.latency_p99 < mid.latency_p99 <= heavy.latency_p99
        assert PW.saturation_point(got["port"]) == light.offered_rate
    elif case in ("churn", "repair_at_admission"):
        for rep in got["port"]:
            assert rep.faults.incomplete == () and not rep.faults.lost
            assert rep.faults.events_applied == 1
    if case == "churn":                 # the schedule through the config
        t1, sched = kill_0_1(models["port"], 1 / 2, F)
        jobs = PW.poisson_jobs(1.0 / t1, 6, CORNERS, nbytes=NBYTES, seed=3)
        assert models["port"].workload(
            jobs, config=SimConfig(faults=sched)).to_dict() == port[1]


def test_single_job_bit_identical_to_simulate_pipeline(models):
    model = models["port"]
    for root in (0, 63):
        plan = model.plan(root)
        cand, m = plan.select(NBYTES, top=1)[0]
        t_ref, res, _ = model.simulate_pipeline(
            cand.pipeline, NBYTES, m, root,
            config=SimConfig(max_sim_groups=m))
        sim = CompiledSim(model.topo, model.cm, 0)
        pkts = [NBYTES / m * t.weight for t in cand.pipeline.trees]
        ctl = sim.idx.lower_tasks(
            pipeline_tasks(cand.pipeline, pkts, m),
            total_blocks=m * len(cand.pipeline.trees),
            detect_segments=False)
        jr = sim.run_jobs([JobSpec(arrival=0.0, root=root, ctl=ctl)]).jobs[0]
        assert jr.finish == t_ref == res.finish_time
        assert jr.node_finish == res.node_finish
        rep = model.workload([PW.BroadcastJob(0.0, root, NBYTES)])
        assert rep.jobs[0].finish == rep.makespan == t_ref
        assert rep.completed == res.completed


def test_single_job_churn_bit_identical_to_fault_oracle(models):
    model = models["port"]
    _, sched = kill_0_1(model, 1 / 3, F)
    cand, m = model.plan(0).select(NBYTES, top=1)[0]
    pkts = [NBYTES / m * t.weight for t in cand.pipeline.trees]
    ref = EventSimulator(model.topo, model.cm, 0).run(
        pipeline_tasks(cand.pipeline, pkts, m),
        total_blocks=m * len(cand.pipeline.trees), faults=sched)
    rep = model.workload([PW.BroadcastJob(0.0, 0, NBYTES)], faults=sched)
    assert rep.jobs[0].finish == ref.finish_time
    assert (rep.started, rep.completed) == (ref.started, ref.completed)
    assert rep.faults.lost == ref.faults.lost
    assert rep.faults.incomplete == ref.faults.incomplete


def test_one_orbit_of_roots_builds_one_plan():
    model = api.compile(T.mesh2d(8, 8), server=True)
    model.workload(PW.poisson_jobs(rate=1e4, num_jobs=12, roots=CORNERS,
                                   nbytes=NBYTES, seed=1))
    assert model.server.stats.builds == 1       # corners share one orbit


def path3():
    topo = T.mesh2d(1, 3)
    sim = CompiledSim(topo, ConflictModel(topo, FULL_DUPLEX), 0)
    tasks = [SendTask(priority=(0,), src=0, dst=1, nbytes=1024.0),
             SendTask(priority=(1,), src=1, dst=2, nbytes=1024.0, deps=(0,))]
    ctl = sim.idx.lower_tasks(tasks, total_blocks=1, detect_segments=False)
    lat, bw = sim.idx.edge_cost((0, 1))
    return sim, ctl, lat + 1024.0 / bw      # d = per-hop time


@pytest.mark.parametrize("arrival,start,finish", [
    (1.0, 1.0, 3.0),          # B takes the freed 0->1 link, waits on 1->2
    (0.5, 1.0, 3.0),          # B queues on 0->1 until A frees it
    (0.25, 1.0, 3.0),         # no preemption of A's running send
])
def test_two_job_contention_hand_derived(arrival, start, finish):
    sim, ctl, d = path3()
    mr = sim.run_jobs([JobSpec(0.0, 0, ctl, 0),
                       JobSpec(arrival * d, 0, ctl, 1)])
    a, b = mr.jobs
    assert a.start == 0.0 and a.finish == 2 * d
    assert b.start == start * d and b.finish == finish * d
    assert b.queue_delay == (start - arrival) * d
    assert mr.makespan == 3 * d and mr.started == mr.completed == 4


def test_arrivals_equal_reference():
    kw = dict(rate=1e3, num_jobs=400, roots=[3, 5],
              nbytes=[1e4, 2e4, 3e4], seed=0)
    jobs = PW.poisson_jobs(**kw)
    assert [dataclasses.astuple(j) for j in jobs] == \
        [dataclasses.astuple(j) for j in RW.poisson_jobs(**kw)]
    assert [j.root for j in jobs[:4]] == [3, 5, 3, 5]
    uni = dict(kw, uniform_roots=True, nbytes=1e4, deadline=1e-3)
    assert [dataclasses.astuple(j) for j in PW.poisson_jobs(**uni)] == \
        [dataclasses.astuple(j) for j in RW.poisson_jobs(**uni)]
    trace = [(2e-5, 7, 1e5), (0.0, 0, 1e5, 5e-4)]
    tj = PW.trace_jobs(trace)
    assert [dataclasses.astuple(j) for j in tj] == \
        [dataclasses.astuple(j) for j in RW.trace_jobs(trace)]
    assert [j.job_id for j in tj] == [0, 1] and tj[0].deadline == 5e-4
