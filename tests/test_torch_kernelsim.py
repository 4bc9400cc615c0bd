"""The port's event core (``repro_torch.core.kernelsim``) against the
reference's jitted one, case for case with ``tests/test_kernel.py``.

On the CPU the port's ``KernelSim(device="cpu")`` runs the plain PyTorch
core (``event_core_ref``); the CUDA kernel is held to it on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py`` ``[eventcore]``). The
contract: bit-identical to the numpy engine and to the reference's
``KernelSim.run_lowered(jit=True)`` -- every ``SimResult`` field equal, not
close -- on every list the core accepts; everything the core lacks (faults,
foldable lists, empty lists) delegates to the numpy engine; cuda asked for
on a host without a GPU raises. Tolerance: exact.
"""

import numpy as np
import pytest
import torch

from repro.core import kernelsim as RKS
from repro.core import topology as RT
from repro.core.baselines import lower_baseline as ref_lower
from repro.core.intersection import ConflictModel as RefCM
from repro_torch.core import kernelsim as KS
from repro_torch.core import topology as T
from repro_torch.core.baselines import lower_baseline, simulate_baseline
from repro_torch.core.fastsim import CompiledSim, TaskListRun
from repro_torch.core.intersection import ALL_PORT, FULL_DUPLEX, ConflictModel
from repro_torch.core.simconfig import DeviceConfig, SimConfig

TOPOS = [
    ("mesh2d-4x6", lambda T: T.mesh2d(4, 6), FULL_DUPLEX),
    ("mesh2d-16x16", lambda T: T.mesh2d(16, 16), FULL_DUPLEX),
    ("dragonfly", lambda T: T.dragonfly(4, 4, 2), ALL_PORT),
    ("fat_tree", lambda T: T.fat_tree(4), FULL_DUPLEX),
]
NAMES = ["binomial", "flat", "pipeline", "srda", "glf", "bine", "mpi_bcast"]
CPU = SimConfig(engine="kernel", device=DeviceConfig(device="cpu"))


def _same(a, b):
    return (a.finish_time == b.finish_time and a.deliveries == b.deliveries
            and a.node_finish == b.node_finish
            and a.group_finish == b.group_finish
            and a.started == b.started and a.completed == b.completed)


def _ref_result(r):
    """A reference ``SimResult`` as the port's fields (the classes differ)."""
    from repro_torch.core.simulator import SimResult
    return SimResult(finish_time=r.finish_time, node_finish=r.node_finish,
                     deliveries=r.deliveries, group_finish=r.group_finish,
                     started=r.started, completed=r.completed)


def _sim(topo, cm, root=0):
    return KS.KernelSim(topo, cm, root, device="cpu")


@pytest.mark.parametrize("tname,mk,mode", TOPOS, ids=[t[0] for t in TOPOS])
@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("size", [4e4, 64e6])
def test_forced_core_bit_identical_to_reference(tname, mk, mode, name, size):
    rtopo, topo = mk(RT), mk(T)
    rcm, cm = RefCM(rtopo, mode), ConflictModel(topo, mode)
    rctl = ref_lower(rtopo, rcm, name, 0, size)
    ctl = lower_baseline(topo, cm, name, 0, size)
    # both packages lower to the same arrays
    assert ctl.n == rctl.n and ctl.rank == rctl.rank
    assert ctl.deps == rctl.deps
    assert list(ctl.durs) == list(rctl.durs)
    rctl.bind(rcm.compiled())
    ctl.bind(cm.compiled())
    assert ctl.res_ids == rctl.res_ids
    if not (ctl.seg is not None and ctl.seg.foldable):
        for a, b in zip(KS._static_arrays(ctl, cm.compiled()),
                        RKS._static_arrays(rctl, rcm.compiled())):
            np.testing.assert_array_equal(a, b)

    got = _sim(topo, cm).run_lowered(ctl, jit=True)
    assert _same(got, CompiledSim(topo, cm, 0).run_lowered(ctl))
    ref = RKS.KernelSim(rtopo, rcm, 0).run_lowered(rctl, jit=True)
    assert _same(got, _ref_result(ref))


def test_plain_core_matches_reference_core_on_raw_arrays():
    """``event_core_ref`` on the reference's own padded arrays returns the
    reference core's completion times and sequence numbers exactly, over
    three lanes of one structure."""
    rtopo = RT.mesh2d(16, 16)
    rcm = RefCM(rtopo, FULL_DUPLEX)
    rctl, durs, _ = RKS.lower_baseline_lanes(rtopo, rcm, "glf", 0,
                                             [1e5, 3e7, 1e9])
    rctl.bind(rcm.compiled())
    stat = RKS._static_arrays(rctl, rcm.compiled())
    want_comp, want_seqs = RKS._CORE_BATCH(*stat, durs)
    comp, seqs = KS.event_core(*(torch.from_numpy(a) for a in stat),
                               torch.from_numpy(durs))
    assert comp.dtype == torch.float64 and seqs.dtype == torch.int32
    np.testing.assert_array_equal(comp.numpy(), np.asarray(want_comp))
    np.testing.assert_array_equal(seqs.numpy(), np.asarray(want_seqs))


@pytest.mark.parametrize("zero_cap", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_plain_core_matches_reference_core_on_random_structures(seed,
                                                                zero_cap):
    """Ties in finish times, repeated resource ids, dummy pads and (with
    ``zero_cap``) a resource that never frees, where the reference's
    completion step runs with ``min(fin)`` inf: the plain core still
    returns exactly what the reference's core returns."""
    rng = np.random.default_rng(seed)
    stat = KS.random_structure(rng, 40, 3, zero_cap=zero_cap)
    want_comp, want_seqs = RKS._CORE_BATCH(*stat)
    comp, seqs = KS.event_core(*(torch.from_numpy(a) for a in stat))
    np.testing.assert_array_equal(comp.numpy(), np.asarray(want_comp))
    np.testing.assert_array_equal(seqs.numpy(), np.asarray(want_seqs))
    assert np.isinf(comp.numpy()).any() == zero_cap


@pytest.mark.parametrize("jit", [True, False])
def test_lane_batch_matches_per_size_runs(jit):
    topo = T.mesh2d(16, 16)
    cm = ConflictModel(topo, FULL_DUPLEX)
    nsim = CompiledSim(topo, cm, 0)
    sizes = np.geomspace(1e5, 1e9, 12).tolist()
    ctl, durs, nbytes = KS.lower_baseline_lanes(topo, cm, "binomial", 0,
                                                sizes)
    refs = [nsim.run_lowered(lower_baseline(topo, cm, "binomial", 0, s))
            for s in sizes]
    got = _sim(topo, cm).run_lowered_batch(ctl, durs, nbytes, jit=jit)
    assert len(got) == len(sizes)
    assert all(_same(g, r) for g, r in zip(got, refs))


def test_lane_batch_foldable_goes_through_folded_core(monkeypatch):
    # srda on a non-power-of-two node count lowers to the ring allgather,
    # which folds; the batch routes lanes through the folded numpy core
    topo = T.mesh2d(4, 6)
    cm = ConflictModel(topo, FULL_DUPLEX)
    nsim = CompiledSim(topo, cm, 0)
    sizes = [4e6, 16e6, 64e6]
    ctl, durs, nbytes = KS.lower_baseline_lanes(topo, cm, "srda", 0, sizes)
    assert ctl.seg is not None and ctl.seg.foldable
    refs = [nsim.run_lowered(lower_baseline(topo, cm, "srda", 0, s))
            for s in sizes]

    def boom(*a, **k):
        raise AssertionError("a foldable lane batch hit the event core")

    monkeypatch.setattr(KS, "event_core", boom)
    got = _sim(topo, cm).run_lowered_batch(ctl, durs, nbytes, jit=True)
    assert all(_same(g, r) for g, r in zip(got, refs))


def test_lane_batching_rejects_chain_family():
    # the chain family re-segments per message size: no shared structure
    topo = T.mesh2d(4, 6)
    cm = ConflictModel(topo, FULL_DUPLEX)
    with pytest.raises(ValueError, match="lowered structure"):
        KS.lower_baseline_lanes(topo, cm, "pipeline", 0, [4e6, 64e6])


def test_foldable_list_never_reaches_the_core(monkeypatch):
    topo = T.mesh2d(4, 6)
    cm = ConflictModel(topo, FULL_DUPLEX)
    ctl = lower_baseline(topo, cm, "srda", 0, 64e6)
    assert ctl.seg is not None and ctl.seg.foldable

    def boom(*a, **k):
        raise AssertionError("foldable list hit the event core")

    monkeypatch.setattr(KS, "event_core", boom)
    ref = CompiledSim(topo, cm, 0).run_lowered(ctl)
    assert _same(_sim(topo, cm).run_lowered(ctl, jit=True), ref)
    # on cuda too: a foldable list needs no device
    ks = KS.KernelSim(topo, cm, 0, device="cuda")
    assert _same(ks.run_lowered(ctl, jit=True), ref)


def test_core_off_delegates_everything(monkeypatch):
    """With the core off (``jit=False``, or ``REPRO_KERNEL_JIT=0`` on a cuda
    sim), lists and lane batches run the numpy engine and need no device."""
    topo = T.mesh2d(4, 6)
    cm = ConflictModel(topo, FULL_DUPLEX)
    ctl = lower_baseline(topo, cm, "binomial", 0, 64e6)
    ref = CompiledSim(topo, cm, 0).run_lowered(ctl)
    monkeypatch.setattr(KS, "event_core", None)        # never called
    assert _same(_sim(topo, cm).run_lowered(ctl, jit=False), ref)
    monkeypatch.setenv("REPRO_KERNEL_JIT", "off")
    ks = KS.KernelSim(topo, cm, 0, device="cuda")
    assert _same(ks.run_lowered(ctl), ref)
    got = ks.run_lowered_batch(ctl, np.asarray([ctl.durs], dtype=np.float64))
    assert len(got) == 1 and _same(got[0], ref)


def test_faults_delegate_to_numpy_fault_loop():
    from repro_torch.core import faults as F
    from repro_torch.core.baselines import BASELINES

    topo = T.mesh2d(4, 6)
    cm = ConflictModel(topo, FULL_DUPLEX)
    tasks = BASELINES["binomial"](topo, 0, 1e6)
    tb = max(t.blk[1] for t in tasks)
    link = topo.links((0, 1))[0]
    sched = F.FaultSchedule.kill_link(link, time=1e-6)
    ref = CompiledSim(topo, cm, 0).run(tasks, total_blocks=tb, faults=sched)
    # a cuda sim: faults need no device
    got = KS.KernelSim(topo, cm, 0, device="cuda").run(
        tasks, total_blocks=tb, faults=sched)
    assert got.finish_time == ref.finish_time
    assert got.faults.events_applied == ref.faults.events_applied


def test_run_task_list_interception():
    topo = T.mesh2d(16, 16)
    cm = ConflictModel(topo, FULL_DUPLEX)
    ctl = lower_baseline(topo, cm, "binomial", 0, 64e6)
    ref = CompiledSim(topo, cm, 0).run_lowered(ctl)
    tlr = _sim(topo, cm).run_task_list(lowered=ctl, jit=True)
    assert isinstance(tlr, TaskListRun)
    assert tlr.sim_segments == 0 and _same(tlr.res, ref)
    # a raw task list lowers first
    from repro_torch.core.baselines import BASELINES
    tasks = BASELINES["binomial"](topo, 0, 64e6)
    raw = _sim(topo, cm).run_task_list(
        tasks, total_blocks=max(t.blk[1] for t in tasks), jit=True)
    assert raw.sim_segments == 0 and _same(raw.res, ref)


def test_jit_policy_env(monkeypatch):
    monkeypatch.setenv("REPRO_KERNEL_JIT", "force")
    assert KS._jit_default("cpu") is True
    monkeypatch.setenv("REPRO_KERNEL_JIT", "on")
    assert KS._jit_default("cpu") is True
    monkeypatch.setenv("REPRO_KERNEL_JIT", "0")
    assert KS._jit_default("cuda") is False
    monkeypatch.setenv("REPRO_KERNEL_JIT", "off")
    assert KS._jit_default("cuda") is False
    monkeypatch.delenv("REPRO_KERNEL_JIT")
    # unset: the core where the sim's device is a GPU
    assert KS._jit_default("cuda") is True
    assert KS._jit_default("cuda:0") is True
    assert KS._jit_default("cpu") is False


def test_default_policy_runs_the_core_only_when_asked_on_cpu(monkeypatch):
    """Unset policy: a CPU sim runs the numpy engine, a cuda sim the core;
    ``jit=True`` on a CPU sim runs the plain core."""
    monkeypatch.delenv("REPRO_KERNEL_JIT", raising=False)
    topo = T.mesh2d(4, 6)
    cm = ConflictModel(topo, FULL_DUPLEX)
    ctl = lower_baseline(topo, cm, "glf", 0, 64e6)
    calls = []
    real = KS.event_core

    def spy(*a):
        calls.append(a[-1].device.type)
        return real(*a)

    monkeypatch.setattr(KS, "event_core", spy)
    ref = CompiledSim(topo, cm, 0).run_lowered(ctl)
    assert _same(_sim(topo, cm).run_lowered(ctl), ref) and calls == []
    assert _same(_sim(topo, cm).run_lowered(ctl, jit=True), ref)
    assert calls == ["cpu"]


def test_cuda_without_gpu_raises(monkeypatch):
    """The kernel engine asked for cuda (the default) on a host without a
    GPU raises when the core is about to run; it never runs on the CPU."""
    monkeypatch.delenv("REPRO_KERNEL_JIT", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    topo = T.mesh2d(4, 6)
    cm = ConflictModel(topo, FULL_DUPLEX)
    called = []
    monkeypatch.setattr(KS, "event_core_ref",
                        lambda *a: called.append(1))
    for cfg in (SimConfig(engine="kernel"),
                SimConfig(engine="kernel", device=DeviceConfig())):
        with pytest.raises(RuntimeError, match="cuda"):
            simulate_baseline(topo, cm, "binomial", 0, 64e6, config=cfg)
    ctl = lower_baseline(topo, cm, "glf", 0, 64e6)
    with pytest.raises(RuntimeError, match="cuda"):
        KS.KernelSim(topo, cm, 0).run_lowered(ctl, jit=True)
    with pytest.raises(RuntimeError, match="cuda"):
        KS.KernelSim(topo, cm, 0).run_lowered_batch(
            ctl, np.asarray([ctl.durs], dtype=np.float64))
    assert called == []


@pytest.mark.parametrize("name", ["binomial", "srda", "pipeline", "glf"])
def test_api_kernel_engine_matches_fast(name):
    topo = T.mesh2d(16, 16)
    cm = ConflictModel(topo, FULL_DUPLEX)
    rk = simulate_baseline(topo, cm, name, 0, 64e6, config=CPU)
    rf = simulate_baseline(topo, cm, name, 0, 64e6,
                           config=SimConfig(engine="fast"))
    assert _same(rk, rf)


def test_event_core_checks_its_arguments():
    """Wrong dtypes or shapes raise; a tensor off the CPU and CUDA (``meta``
    stands in for a device without the kernel) raises and never takes the
    plain path."""
    n, L = 4, 2
    rank = torch.arange(n, dtype=torch.int32)
    res = torch.zeros((n, 1), dtype=torch.int32)
    caps = torch.ones(1, dtype=torch.int32)
    deps = torch.full((n, 1), n, dtype=torch.int32)
    durs = torch.ones((L, n), dtype=torch.float64)
    comp, seqs = KS.event_core(rank, res, caps, deps, durs)
    # one resource of capacity 1: the tasks run one after another by rank
    assert comp.tolist() == [[1.0, 2.0, 3.0, 4.0]] * L
    assert seqs.tolist() == [[0, 1, 2, 3]] * L
    with pytest.raises(ValueError, match="float64"):
        KS.event_core(rank, res, caps, deps, durs.float())
    with pytest.raises(ValueError, match="rank"):
        KS.event_core(rank.long(), res, caps, deps, durs)
    with pytest.raises(ValueError, match="deps"):
        KS.event_core(rank, res, caps, deps[:3], durs)
    with pytest.raises(ValueError, match="contiguous"):
        KS.event_core(rank, res, caps, deps, durs.t().contiguous().t())
    meta = [t.to("meta") for t in (rank, res, caps, deps, durs)]
    with pytest.raises(ValueError, match="cuda or cpu"):
        KS.event_core(*meta)
    with pytest.raises(ValueError, match="rank"):          # mixed devices
        KS.event_core(rank, *meta[1:])


def test_make_engine_and_executable_carry_the_device_block():
    """``make_engine(engine="kernel")`` is the port's ``KernelSim`` on the
    asked device; an executable of a baseline built with the kernel engine
    and a CPU device block predicts on the CPU (the rebuilt ``SimConfig``
    keeps the caller's device block) and equals the fast engine's."""
    from repro_torch import api
    from repro_torch.core.simulator import make_engine

    topo = T.ring(8)
    cm = ConflictModel(topo)
    sim = make_engine(topo, cm, 0, engine="kernel", device="cpu")
    assert isinstance(sim, KS.KernelSim) and sim.device == "cpu"
    assert make_engine(topo, cm, 0, engine="kernel").device == "cuda"
    model = api.compile(topo)
    dev = DeviceConfig(device="cpu")
    exk = model.executable(root=0, nbytes=4096, algo="binomial",
                           config=SimConfig(engine="kernel", device=dev))
    exf = model.executable(root=0, nbytes=4096, algo="binomial",
                           config=SimConfig(device=dev))
    assert exk.predicted_time == exf.predicted_time
    assert exk.verify(exk.default_payload()).ok


# --- the CUDA kernel's bookkeeping (csrc/event_core.cu), modelled in numpy --

_WAIT, _READY, _PARKED, _RUN, _DONE = range(5)


def _compacted(stat):
    """``compact_structure`` of numpy inputs, as numpy arrays."""
    st = KS.compact_structure(*(torch.from_numpy(np.ascontiguousarray(a))
                                for a in stat[:4]))
    return KS.Compacted(*(t.numpy() for t in st))


class _Bitmap:
    """The kernel's two-level ready bitmap: a bit a rank in 32-bit words,
    and a summary bit a word that is not zero."""

    def __init__(self, n):
        self.nw = (n + 31) // 32
        self.bits = [0] * self.nw
        self.sum = [0] * ((self.nw + 31) // 32)

    def set(self, p):
        p = int(p)
        w = p >> 5
        if not self.bits[w]:
            self.sum[w >> 5] |= 1 << (w & 31)
        self.bits[w] |= 1 << (p & 31)

    def clear(self, p):
        p = int(p)
        w = p >> 5
        self.bits[w] &= ~(1 << (p & 31))
        if not self.bits[w]:
            self.sum[w >> 5] &= ~(1 << (w & 31))

    def first(self):
        """The least set rank, or -1 (``first_ready``)."""
        for s, sm in enumerate(self.sum):
            if sm:
                w = (s << 5) + _ffs(sm)
                return (w << 5) + _ffs(self.bits[w])
        return -1


def _ffs(m):
    return (m & -m).bit_length() - 1


def _model_core(st, durs, cands=32):
    """What one block of ``csrc/event_core.cu`` computes for each lane, step
    by step: up to ``cands`` least ready ranks (the set bits of the 32
    words from the first that is not zero) checked against the same room;
    the least that passes is admitted, those ahead of it park on their
    first full resource, those behind it are checked again against the
    room it left, and so on through the window; a completion pops the
    least running (fin, seq) (a heap here, slots with block minima in the
    kernel: the same order), wakes every waiter of the freed resources and,
    on a first completion, drops the children's counts; the scan of all n
    ``(seq, index)`` keys when nothing runs or the least finish is inf.
    ``cands=1`` checks one rank at a time."""
    import heapq

    L, n = durs.shape
    comp = np.zeros((L, n))
    seqs = np.full((L, n), int(KS._BIG_SEQ), dtype=np.int64)
    for lane in range(L):
        room = st.caps.astype(np.int64)
        head = [-1] * room.size
        nxt = [-1] * n
        depc = st.dep_n.astype(np.int64)
        status = [_WAIT] * n
        bm = _Bitmap(n)
        for p in range(n):
            if not depc[p]:
                status[p] = _READY
                bm.set(p)
        heap, now, ctr, ncomp = [], 0.0, 0, 0

        def row(p):
            return st.row_res[st.row_ptr[p]:st.row_ptr[p + 1]]

        def first_full(p):
            full = [int(r) for r in row(p) if room[r] <= 0]
            return full[0] if full else -1

        while ncomp < n:
            while True:                # admissions until none is possible
                cand, p0 = [], bm.first()
                if p0 >= 0:
                    for w in range(p0 >> 5, min((p0 >> 5) + 32, bm.nw)):
                        cand += [(w << 5) + b for b in range(32)
                                 if bm.bits[w] >> b & 1]
                    cand = cand[:cands]
                if not cand:
                    break
                # the window: the least that passes is admitted, those
                # before it park, the rest are checked again
                blk = [first_full(p) for p in cand]
                start = 0
                while start < len(cand):
                    a = next((k for k in range(start, len(cand))
                              if blk[k] < 0), len(cand))
                    for p, r in zip(cand[start:a], blk[start:a]):
                        bm.clear(p)
                        status[p] = _PARKED
                        nxt[p], head[r] = head[r], p
                    if a == len(cand):
                        break
                    p = cand[a]
                    np.subtract.at(room, row(p), 1)
                    bm.clear(p)
                    status[p] = _RUN
                    t = int(st.inv[p])
                    heapq.heappush(heap, (now + durs[lane, t], ctr, p))
                    seqs[lane, t] = ctr
                    ctr += 1
                    start = a + 1
                    blk[start:] = [first_full(q) for q in cand[start:]]
            if heap and heap[0][0] != np.inf:
                m, _, j = heapq.heappop(heap)
            else:
                t = int(np.lexsort((np.arange(n), seqs[lane]))[0])
                j, m = int(st.rank[t]), np.inf
                if status[j] == _RUN:
                    assert heap[0][2] == j
                    heapq.heappop(heap)
            now = m
            comp[lane, st.inv[j]] = m
            first = status[j] != _DONE
            if status[j] == _READY:
                bm.clear(j)
            status[j] = _DONE
            ncomp += 1
            np.add.at(room, row(j), 1)
            for r in row(j):
                t, head[r] = head[r], -1
                while t >= 0:
                    if status[t] == _PARKED:
                        status[t] = _READY
                        bm.set(t)
                    t = nxt[t]
            if first:
                for c in st.ch[st.ch_ptr[j]:st.ch_ptr[j + 1]]:
                    depc[c] -= 1
                    if not depc[c] and status[c] == _WAIT:
                        status[c] = _READY
                        bm.set(c)
    return comp, seqs.astype(np.int32)


def _naive_compaction(rank, res, caps, deps):
    """``compact_structure`` with loops, for the test."""
    n = rank.size
    occ = np.zeros(caps.size, dtype=np.int64)
    for r in res.reshape(-1):
        occ[r] += 1
    kept = [r for r in range(caps.size) if caps[r] <= occ[r]]
    new = {r: k for k, r in enumerate(kept)}
    inv = np.argsort(rank)
    rows = [[new[r] for r in res[t] if r in new] for t in inv]
    children = [[] for _ in range(n)]
    for t in range(n):
        for d in deps[t]:
            if d != n:
                children[rank[d]].append(int(rank[t]))
    return inv, rows, caps[kept], [int((deps[t] != n).sum()) for t in inv], \
        children


def _structures():
    """Random structures (ties, repeats, pads at random positions, caps 1
    and 2, a zero capacity, empty rows) and a few lowered lists."""
    out = []
    for seed, zero_cap in ((0, False), (1, True), (2, False), (3, True)):
        rng = np.random.default_rng(seed)
        n = (40, 97, 200, 333)[seed]
        out.append((f"random-{seed}-{zero_cap}", KS.random_structure(
            rng, n, 3, nres=max(2, n // 8), K=5, D=3, zero_cap=zero_cap)))
    return out


@pytest.mark.parametrize("case", range(4))
def test_compaction_keeps_the_entries_that_can_block(case):
    """Every entry of a resource whose capacity is at most its count of
    occurrences stays, in row order and with its multiplicity; every other
    goes; ranks, dependency counts and children match the padded input."""
    name, stat = _structures()[case]
    rank, res, caps, deps = stat[:4]
    st = _compacted(stat)
    inv, rows, kcaps, dep_n, children = _naive_compaction(rank, res, caps,
                                                          deps)
    np.testing.assert_array_equal(st.inv, inv)
    np.testing.assert_array_equal(st.caps, kcaps)
    np.testing.assert_array_equal(st.dep_n, dep_n)
    for p in range(rank.size):
        assert st.row_res[st.row_ptr[p]:st.row_ptr[p + 1]].tolist() == rows[p]
        assert sorted(st.ch[st.ch_ptr[p]:st.ch_ptr[p + 1]].tolist()) == \
            sorted(children[p])
    # the dummy pad never stays, a zero capacity always does where used
    assert caps.size - 1 not in np.nonzero(caps <= np.bincount(
        res.reshape(-1), minlength=caps.size))[0]
    if caps[0] == 0 and (res == 0).any():
        assert st.caps[0] == 0
    assert st.row_ptr[-1] == st.row_res.size < res.size


@pytest.mark.parametrize("tname,mk,mode", TOPOS, ids=[t[0] for t in TOPOS])
def test_compaction_of_lowered_lists(tname, mk, mode):
    """The matrix lists (64e6 B): the compacted rows are the padded rows
    without the dummy and without resources too wide to block, and the
    children CSR is the inverse of the dependency rows."""
    topo = mk(T)
    cm = ConflictModel(topo, mode)
    for name in NAMES:
        ctl = lower_baseline(topo, cm, name, 0, 64e6)
        if ctl.seg is not None and ctl.seg.foldable:
            continue
        ctl.bind(cm.compiled())
        stat = KS._static_arrays(ctl, cm.compiled())
        st = _compacted(stat)
        inv, rows, kcaps, dep_n, children = _naive_compaction(*stat)
        np.testing.assert_array_equal(st.caps, kcaps)
        np.testing.assert_array_equal(st.dep_n, dep_n)
        assert [st.row_res[st.row_ptr[p]:st.row_ptr[p + 1]].tolist()
                for p in range(ctl.n)] == rows
        assert [sorted(st.ch[st.ch_ptr[p]:st.ch_ptr[p + 1]].tolist())
                for p in range(ctl.n)] == [sorted(c) for c in children]
        assert st.row_res.size <= stat[1].size


@pytest.mark.parametrize("cands", [1, 32])
@pytest.mark.parametrize("case", range(4))
def test_kernel_model_matches_plain_core_on_random_structures(case, cands):
    """The kernel's bookkeeping, in numpy, against ``event_core_ref`` bit
    for bit: zero capacities (where nothing runs and a done or
    unstarted task wins the scan of all n keys), ties, repeats, pads."""
    name, stat = _structures()[case]
    want = KS.event_core(*(torch.from_numpy(a) for a in stat))
    comp, seqs = _model_core(_compacted(stat), stat[4], cands)
    np.testing.assert_array_equal(comp, want[0].numpy())
    np.testing.assert_array_equal(seqs, want[1].numpy())
    if "True" in name:
        assert np.isinf(comp).any()


@pytest.mark.parametrize("tname,mk,mode", TOPOS, ids=[t[0] for t in TOPOS])
@pytest.mark.parametrize("size", [4e4, 64e6])
def test_kernel_model_matches_numpy_engine_on_matrix_lists(tname, mk, mode,
                                                           size):
    """The kernel's bookkeeping on the ``tests/test_kernel.py`` lists: its
    completion times and sequence numbers are ``event_core_ref``'s and give
    every ``SimResult`` field of the numpy engine; one candidate at a time
    gives the same."""
    topo = mk(T)
    cm = ConflictModel(topo, mode)
    ks = _sim(topo, cm)
    for name in NAMES:
        ctl = lower_baseline(topo, cm, name, 0, size)
        if ctl.seg is not None and ctl.seg.foldable:
            continue
        ctl.bind(cm.compiled())
        stat = KS._static_arrays(ctl, cm.compiled())
        st = _compacted(stat)
        durs = np.asarray([ctl.durs], dtype=np.float64)
        comp, seqs = _model_core(st, durs, cands=1 if size < 1e6 else 32)
        want = KS.event_core_ref(*(torch.from_numpy(a) for a in stat),
                                 torch.from_numpy(durs))
        np.testing.assert_array_equal(comp, want[0].numpy())
        np.testing.assert_array_equal(seqs, want[1].numpy())
        got = ks._postprocess(ctl, comp[0], seqs[0].astype(np.int64))
        assert _same(got, CompiledSim(topo, cm, 0).run_lowered(ctl)), name
