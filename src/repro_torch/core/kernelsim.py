"""The simulator's event core on the card: ``KernelSim`` and ``event_core``.

The counterpart of ``repro.core.kernelsim``. ``KernelSim`` runs a lowered
task list (``repro_torch.core.routing.CompiledTaskList``) through the
park-free event core instead of the numpy engine's Python event loop. The
core consumes the lowered arrays -- admission ranks, the resource rows
padded to one width, the dependency rows, the Hockney durations -- and
replays the numpy engine's exact schedule: every step either admits the
admissible task of least rank (unstarted, every dependency done, every
resource below capacity) or, when none is admissible, completes the running
task of least ``(finish, seq)``, until all n have completed. Each run takes
exactly ``2n`` steps, and the only arithmetic is the float64 add
``now + dur``, so event times are bit-identical to the numpy engine's, not
merely close (the reference's docstring gives the park-free argument).
Coverage, node finishes, deliveries and group finishes are recovered from
the per-task completion times and admission sequence numbers afterwards
(``_postprocess``, numpy, as in the reference).

``event_core`` is the core for ``L`` lanes (message sizes) that share one
structure: on CUDA tensors ``compact_structure`` (the rows cut to the
entries that can block, tasks relabelled by rank, the children of each
task) and one launch of the hand-written kernel ``csrc/event_core.cu``
(``launch``: one warp a lane, the lane's 2n steps inside it, a ready
bitmap, parked waiters and a running list, so a step touches only what
its effect changes); on CPU tensors the plain PyTorch version
``event_core_ref``; on any other device it raises. ``launches`` counts the
kernel's launches.

Dispatch, as in the reference:

* fold-eligible lists (``ctl.seg.foldable``), fault schedules, the
  segment-analytic ``run_task_list`` path for foldable lists and empty
  lists go to the port's ``CompiledSim``, bit-identically, on no device;
* everything else takes the core when the jit policy says so: always with
  ``REPRO_KERNEL_JIT=1``/``force``/``on`` or ``jit=True``, never with
  ``REPRO_KERNEL_JIT=0``/``off`` or ``jit=False``, and by default when the
  sim's device is cuda (the reference asks whether jax sees more than one
  device: the accelerator is where the core pays). The device is resolved
  when the core is about to run, so cuda asked for on a host without a GPU
  raises and never runs on the CPU.

``run_lowered_batch`` runs lanes that share one lowered structure (only
durations and payload bytes differ) in one ``event_core`` call;
``lower_baseline_lanes`` lowers a baseline at several sizes into such
lanes.
"""

from __future__ import annotations

import copy
import ctypes
import os
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.fastsim import CompiledSim, TaskListRun
from repro_torch.core.intersection import ConflictModel
from repro_torch.core.routing import CompiledTaskList
from repro_torch.core.simulator import SimResult
from repro_torch.core.topology import Topology

launches = 0          # launches of csrc/event_core.cu since the last reset
variant_launches = {"shared": 0, "global": 0}   # the same, by memory variant

# completions cannot tie on (time, seq): seq is unique, so this sentinel
# only pads the masked argmins
_BIG_SEQ = np.int32(2 ** 31 - 1)

_lib = None


def _jit_default(device) -> bool:
    """Whether the core runs (module docstring): ``REPRO_KERNEL_JIT`` when
    set, else whether ``device`` is a CUDA device."""
    env = os.environ.get("REPRO_KERNEL_JIT", "").lower()
    if env in ("1", "force", "on"):
        return True
    if env in ("0", "off"):
        return False
    return torch.device(device).type == "cuda"


def event_core_ref(rank: torch.Tensor, res: torch.Tensor, caps: torch.Tensor,
                   deps: torch.Tensor, durs: torch.Tensor,
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch event core: the reference's ``_core`` loop with its
    ``vmap`` written out as a leading lane dimension.

    ``rank`` int32 ``[n]`` (a permutation), ``res`` int32 ``[n, K]`` padded
    with the dummy id ``R`` (``caps`` int32 ``[R + 1]``), ``deps`` int32
    ``[n, D]`` padded with ``n`` (the always-done slot), ``durs`` float64
    ``[L, n]``. Returns completion times float64 ``[L, n]`` and admission
    sequence numbers int32 ``[L, n]``, on ``durs``' device."""
    L, n = durs.shape
    dev = durs.device
    rank, res, caps, deps = (t.to(dev) for t in (rank, res, caps, deps))
    nres = caps.shape[0]
    lanes = torch.arange(L, device=dev)
    res_l = res.long()
    # status: 0 unstarted, 1 running, 2 done; slot n = done sentinel, so
    # the padded dependency rows read as satisfied
    status = torch.zeros((L, n + 1), dtype=torch.int8, device=dev)
    status[:, n] = 2
    busy = torch.zeros((L, nres), dtype=torch.int32, device=dev)
    fin = torch.full((L, n), float("inf"), dtype=torch.float64, device=dev)
    seqs = torch.full((L, n), int(_BIG_SEQ), dtype=torch.int32, device=dev)
    comp = torch.zeros((L, n), dtype=torch.float64, device=dev)
    ctr = torch.zeros(L, dtype=torch.int32, device=dev)
    now = torch.zeros(L, dtype=torch.float64, device=dev)
    ncomp = torch.zeros(L, dtype=torch.int32, device=dev)
    big = torch.tensor(int(_BIG_SEQ), dtype=torch.int32, device=dev)
    inf = torch.tensor(float("inf"), dtype=torch.float64, device=dev)
    one = torch.ones((), dtype=torch.int32, device=dev)
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    K = res.shape[1]

    def add_rows(rows: torch.Tensor, inc: torch.Tensor) -> None:
        # busy.at[res[i]].add(inc) per lane: the whole row, a repeated id
        # counting twice
        flat = (lanes[:, None] * nres + res_l[rows]).reshape(-1)
        busy.view(-1).index_add_(0, flat, inc[:, None].expand(L, K)
                                 .reshape(-1))

    while True:
        active = ncomp < n           # the while_loop's cond, per lane
        if not bool(active.any()):
            break
        dep_done = (status[:, deps] == 2).all(dim=2)
        free = busy < caps
        adm = dep_done & (status[:, :n] == 0) & free[:, res].all(dim=2)
        i = torch.argmin(torch.where(adm, rank, n), dim=1)
        any_adm = adm[lanes, i] & active

        # admission effects (no-ops when nothing is admissible)
        status[lanes, i] = torch.where(any_adm, 1, status[lanes, i]).to(
            torch.int8)
        add_rows(i, torch.where(any_adm, one, zero))
        fin[lanes, i] = torch.where(any_adm, now + durs[lanes, i],
                                    fin[lanes, i])
        seqs[lanes, i] = torch.where(any_adm, ctr, seqs[lanes, i])
        ctr = ctr + torch.where(any_adm, one, zero)

        # completion effects (the reference heap pop, when no admission)
        g = ~any_adm & active
        m = fin.min(dim=1).values
        j = torch.argmin(torch.where(fin == m[:, None], seqs, big), dim=1)
        now = torch.where(g, m, now)
        comp[lanes, j] = torch.where(g, m, comp[lanes, j])
        fin[lanes, j] = torch.where(g, inf, fin[lanes, j])
        status[lanes, j] = torch.where(g, 2, status[lanes, j]).to(torch.int8)
        add_rows(j, torch.where(g, -one, zero))
        ncomp = ncomp + torch.where(g, one, zero)
    return comp, seqs


def random_structure(rng: np.random.Generator, n: int, lanes: int,
                     nres: int = 6, K: int = 3, D: int = 2,
                     zero_cap: bool = False) -> Tuple[np.ndarray, ...]:
    """Random core inputs ``(rank, res, caps, deps, durs)`` with the edge
    cases of real lists and beyond (for tests): repeated ids and dummy pads
    in a resource row, capacities of 1 and 2, dependencies on earlier tasks
    padded with ``n``, and integer durations, so finish times tie often.
    ``zero_cap`` gives resource 0 capacity 0: the tasks on it never admit
    and the loop runs the reference's completion step with ``min(fin)``
    inf."""
    rank = rng.permutation(n).astype(np.int32)
    res = rng.integers(0, nres, (n, K))
    res[rng.random((n, K)) < 0.2] = nres
    caps = rng.integers(1, 3, nres + 1)
    caps[nres] = 2 ** 30
    if zero_cap:
        caps[0] = 0
    deps = np.full((n, D), n)
    for i in range(1, n):
        k = int(rng.integers(0, D + 1))
        deps[i, :k] = rng.integers(0, i, k)
    durs = rng.integers(1, 4, (lanes, n)).astype(np.float64)
    return (rank, res.astype(np.int32), caps.astype(np.int32),
            deps.astype(np.int32), durs)


class Compacted(NamedTuple):
    """The structure the kernel walks, shared by every lane and built once
    per call by ``compact_structure``. Tasks are relabelled by rank: row,
    dependency count and children of rank ``p`` belong to task ``inv[p]``.
    Resources that can never block are dropped and the rest renumbered."""
    rank: torch.Tensor       # int32 [n], task -> rank (the input)
    inv: torch.Tensor        # int32 [n], rank -> task
    row_ptr: torch.Tensor    # int32 [n + 1], CSR of the kept resource rows
    row_res: torch.Tensor    # int32 [E], kept ids in [0, W'), repeats kept
    caps: torch.Tensor       # int32 [W'], capacity of each kept resource
    dep_n: torch.Tensor      # int32 [n], unmet dependencies at the start
    ch_ptr: torch.Tensor     # int32 [n + 1], CSR of the children
    ch: torch.Tensor         # int32 [C], child ranks, repeats kept


def compact_structure(rank: torch.Tensor, res: torch.Tensor,
                      caps: torch.Tensor, deps: torch.Tensor) -> Compacted:
    """The padded structure of ``event_core_ref`` as the kernel's CSR, in
    vectorised torch ops on the tensors' device.

    A resource whose capacity exceeds the times it occurs over all rows
    never blocks: its occupancy counts running tasks, each of which holds
    an entry of it, and the task being checked holds one more. Its entries
    are dropped (the dummy pad, capacity 2**30, among them); the others
    stay in row order, a repeated id as often as it occurs, since
    admission adds each entry. The children of a task are the tasks whose
    dependency rows name it, once per naming; the sentinel ``n`` has
    none."""
    n = res.shape[0]
    dev = res.device
    rank_l, res_l, deps_l = rank.long(), res.long(), deps.long()
    occ = torch.bincount(res_l.reshape(-1), minlength=caps.shape[0])
    keep = caps.long() <= occ
    kid = torch.cumsum(keep, 0) - 1
    inv = torch.argsort(rank_l)
    rows = res_l[inv]
    kept = keep[rows]
    row_ptr = torch.zeros(n + 1, dtype=torch.long, device=dev)
    row_ptr[1:] = torch.cumsum(kept.sum(1), 0)
    named = deps_l != n
    parent = rank_l[deps_l[named]]
    child = rank_l[torch.arange(n, device=dev)[:, None].expand_as(deps_l)[
        named]]
    order = torch.argsort(parent, stable=True)
    ch_ptr = torch.zeros(n + 1, dtype=torch.long, device=dev)
    ch_ptr[1:] = torch.cumsum(torch.bincount(parent, minlength=n), 0)
    i32 = torch.int32
    return Compacted(rank=rank, inv=inv.to(i32), row_ptr=row_ptr.to(i32),
                     row_res=kid[rows[kept]].to(i32), caps=caps[keep].to(i32),
                     dep_n=named.sum(1)[inv].to(i32), ch_ptr=ch_ptr.to(i32),
                     ch=child[order].to(i32))


def _bind(lib) -> None:
    lib.event_core.argtypes = [ctypes.c_void_p] * 9 + \
        [ctypes.c_int] * 4 + [ctypes.c_void_p] * 4
    lib.event_core.restype = ctypes.c_int
    for fn in (lib.event_core_shared_bytes, lib.event_core_work_bytes):
        fn.argtypes = [ctypes.c_int] * 3
        fn.restype = ctypes.c_longlong
    lib.event_core_max_shared.argtypes = [ctypes.c_int]
    lib.event_core_max_shared.restype = ctypes.c_int


def _kernel():
    global _lib
    if _lib is None:
        from repro_torch.nvcc import load
        lib = load("event_core")
        _bind(lib)
        _lib = lib
    return _lib


def _check(rank, res, caps, deps, durs) -> None:
    if durs.dtype != torch.float64 or durs.dim() != 2 or \
            not durs.is_contiguous():
        raise ValueError(f"durs must be a contiguous float64 [L, n] tensor, "
                         f"got {durs.dtype} {tuple(durs.shape)}")
    L, n = durs.shape
    want = {"rank": (rank, (n,)), "res": (res, (n, None)),
            "caps": (caps, (None,)), "deps": (deps, (n, None))}
    for name, (t, shape) in want.items():
        ok = (t.dtype == torch.int32 and t.dim() == len(shape)
              and all(w is None or w == s for w, s in zip(shape, t.shape))
              and t.is_contiguous() and t.device == durs.device)
        if not ok:
            raise ValueError(f"{name} must be a contiguous int32 tensor of "
                             f"shape "
                             f"{tuple('*' if w is None else w for w in shape)}"
                             f" on {durs.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    if min(res.shape[1], deps.shape[1], caps.shape[0]) < 1:
        raise ValueError("res and deps need one column and caps one entry "
                         "at least (pad with the dummy id and n)")
    if durs.device.type not in ("cuda", "cpu"):
        raise ValueError(f"event_core runs on cuda or cpu, not "
                         f"{durs.device}")
    if n >= 2 ** 31 - 1 or L >= 2 ** 31:
        raise ValueError(f"{L} lanes of {n} tasks do not fit the kernel's "
                         f"int32 indexes")


def event_core(rank: torch.Tensor, res: torch.Tensor, caps: torch.Tensor,
               deps: torch.Tensor, durs: torch.Tensor,
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The event core for ``L`` lanes of one structure (arguments and
    results as ``event_core_ref``): ``compact_structure`` and one launch
    of the CUDA kernel (``launch``) for CUDA tensors, ``event_core_ref``
    for CPU tensors. Every tensor is contiguous and lies on ``durs``'
    device."""
    _check(rank, res, caps, deps, durs)
    if durs.device.type == "cpu":
        return event_core_ref(rank, res, caps, deps, durs)
    return launch(compact_structure(rank, res, caps, deps), durs)


def variant(n: int, nres: int) -> str:
    """The kernel's memory variant for ``n`` tasks and ``nres`` kept
    resources on the current device: ``"shared"`` when every piece of a
    lane's state fits the block's shared memory, else ``"global"`` (task
    state and wait lists in the lane's workspace); raises when not even the
    room, the ready bitmap and the running list's shared slots fit."""
    lib = _kernel()
    for name, flag in (("shared", 1), ("global", 0)):
        if lib.event_core_shared_bytes(n, nres, flag) <= \
                lib.event_core_max_shared(flag):
            return name
    raise ValueError(f"{n} tasks and {nres} resources need "
                     f"{lib.event_core_shared_bytes(n, nres, 0)} B of shared "
                     f"memory a block, the device allows "
                     f"{lib.event_core_max_shared(0)}")


def launch(st: Compacted, durs: torch.Tensor, memory: Optional[str] = None,
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One launch of ``csrc/event_core.cu`` (a warp a lane) over the
    compacted structure ``st`` for ``durs`` float64 ``[L, n]`` on a CUDA
    device; returns what ``event_core_ref`` returns. ``memory`` picks the
    variant (``variant``'s choice by default); a shared-memory size the
    device refuses raises."""
    global launches
    out, memory = _run(_kernel(), st, durs, memory)
    launches += 1
    variant_launches[memory] += 1
    return out


PROFILE_PHASES = ("find", "window", "check", "park/admit", "select",
                  "status", "rows+wake", "children")
PROFILE_COUNTS = ("candidates", "rounds", "parks", "wake hops",
                  "admissions")


def profile(st: Compacted, durs: torch.Tensor,
            memory: Optional[str] = None) -> dict:
    """Where a step's time goes: one launch of the kernel built with
    ``EC_PROFILE`` (not counted in ``launches``), whose first lane adds the
    clock cycles of each phase of a step and counts its work. Returns
    ``{"cycles": {phase: total}, "counts": {name: total}}`` for lane 0 of
    ``durs``, and checks that the results equal ``launch``'s."""
    from repro_torch.nvcc import load
    lib = load("event_core", defines=("EC_PROFILE",))
    _bind(lib)
    lib.event_core_profile.argtypes = [ctypes.c_void_p]
    lib.event_core_profile.restype = ctypes.c_int
    (comp, seqs), _ = _run(lib, st, durs, memory)
    out = (ctypes.c_ulonglong * 16)()
    torch.cuda.synchronize(durs.device)
    if lib.event_core_profile(ctypes.addressof(out)) != 0:
        raise RuntimeError("event_core_profile failed")
    want = _run(_kernel(), st, durs, memory)[0]
    if not (torch.equal(comp, want[0]) and torch.equal(seqs, want[1])):
        raise RuntimeError("the profiled kernel differs from the kernel")
    return {"cycles": dict(zip(PROFILE_PHASES, out[:8])),
            "counts": dict(zip(PROFILE_COUNTS, out[8:13]))}


def _run(lib, st: Compacted, durs: torch.Tensor, memory: Optional[str]):
    if durs.device.type != "cuda":
        raise ValueError(f"the event core kernel runs on cuda, not "
                         f"{durs.device}")
    L, n = durs.shape
    dev = durs.device
    if L == 0 or n == 0:
        return (torch.empty((L, n), dtype=torch.float64, device=dev),
                torch.empty((L, n), dtype=torch.int32, device=dev)), "shared"
    if st.row_res.numel() >= 2 ** 31 or st.ch.numel() >= 2 ** 31:
        raise ValueError("the compacted rows do not fit int32 offsets")
    nres = st.caps.shape[0]
    with torch.cuda.device(dev):
        memory = memory or variant(n, nres)
        if memory not in ("shared", "global"):
            raise ValueError(f"memory is 'shared' or 'global', not "
                             f"{memory!r}")
        flag = int(memory == "shared")
        # the kernel reads durations and writes results in rank order
        durs_r = durs.index_select(1, st.inv.long())
        comp = torch.empty((L, n), dtype=torch.float64, device=dev)
        seqs = torch.empty((L, n), dtype=torch.int32, device=dev)
        per_lane = lib.event_core_work_bytes(n, nres, flag)
        work = torch.empty((L, max(per_lane, 16)), dtype=torch.uint8,
                           device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.event_core(*(t.data_ptr() for t in (
            st.rank, st.inv, st.row_ptr, st.row_res, st.caps, st.dep_n,
            st.ch_ptr, st.ch, durs_r)), n, nres, L, flag, comp.data_ptr(),
            seqs.data_ptr(), work.data_ptr(), stream)
        if rc != 0:
            raise RuntimeError(f"event_core kernel launch failed: CUDA "
                               f"error {rc} ({memory} memory)")
        order = st.rank.long()
        return (comp.index_select(1, order),
                seqs.index_select(1, order)), memory


def _static_arrays(ctl: CompiledTaskList, idx) -> Tuple[np.ndarray, ...]:
    """Pad the lowered CSR into the fixed-width matrices the core consumes
    (lane-independent structure: ranks, resources, dependencies)."""
    n = ctl.n
    rank = np.asarray(ctl.rank, dtype=np.int32)
    # compact the dense ids to the resources this list actually touches:
    # the occupancy vector is a loop carry, so its width is per-iteration
    # memory traffic
    used = np.unique(np.asarray(ctl.res_flat, dtype=np.int64))
    remap = {int(r): k for k, r in enumerate(used)}
    nres = used.size
    K = max(1, max((len(r) for r in ctl.res_ids), default=1))
    res = np.full((n, K), nres, dtype=np.int32)
    for i, rs in enumerate(ctl.res_ids):
        res[i, :len(rs)] = [remap[r] for r in rs]
    caps = np.empty(nres + 1, dtype=np.int64)
    caps[:nres] = np.asarray(idx.caps, dtype=np.int64)[used]
    caps[nres] = 2 ** 30              # the dummy pad id never contends
    D = max(1, max(ctl.dep_n, default=1))
    deps = np.full((n, D), n, dtype=np.int32)   # n = always-done sentinel
    for i, ds in enumerate(ctl.deps):
        deps[i, :len(ds)] = ds
    return rank, res, caps.astype(np.int32), deps


class KernelSim:
    """Drop-in engine: ``run``/``run_lowered`` like ``CompiledSim`` with
    the event core on ``device``; plus ``run_lowered_batch`` for lanes.

    Capability gates delegate to the numpy engine (the exactness oracle):
    fault schedules, foldable lists, the segment-analytic ``run_task_list``
    machinery and empty lists run ``CompiledSim`` bit-identically. The
    ``jit`` keyword (default: ``_jit_default(device)``) picks the path for
    everything else. ``device`` (``"cuda"`` by default, or ``"cpu"`` for
    the plain core) is resolved only when the core runs."""

    def __init__(self, topo: Topology, cm: ConflictModel, root: int,
                 device="cuda"):
        self.topo = topo
        self.cm = cm
        self.root = root
        self.device = device
        self._np = CompiledSim(topo, cm, root)
        self.idx = self._np.idx

    # CompiledSim surface used by the entrypoints -------------------------
    def lower(self, tasks, total_blocks=None):
        return self._np.lower(tasks, total_blocks)

    def run(self, tasks, total_blocks=None, faults=None,
            jit: Optional[bool] = None) -> SimResult:
        if faults:
            # fault events invalidate the static lowering the core
            # consumes; the numpy fault loop is the engine for churn
            return self._np.run(tasks, total_blocks, faults=faults)
        return self.run_lowered(self._np.lower(tasks, total_blocks),
                                jit=jit)

    def run_task_list(self, tasks=None, *, lowered=None,
                      total_blocks=None, max_sim_segments=None,
                      jit: Optional[bool] = None, **kw):
        ctl = (lowered if lowered is not None
               else self._np.lower(tasks, total_blocks))
        seg = ctl.seg
        if seg is not None and seg.foldable:
            # the segment analytics (verified occupancy cycles) and the
            # folded core are numpy paths
            return self._np.run_task_list(
                None, lowered=ctl, max_sim_segments=max_sim_segments, **kw)
        return TaskListRun(res=self.run_lowered(ctl, jit=jit),
                           sim_segments=0, delta=0.0)

    # the core path -------------------------------------------------------
    def _use_core(self, jit: Optional[bool]) -> bool:
        return _jit_default(self.device) if jit is None else jit

    def _core(self, ctl: CompiledTaskList, durs: np.ndarray
              ) -> Tuple[np.ndarray, np.ndarray]:
        """``event_core`` on the sim's device for ``durs`` ``[L, n]``;
        host arrays of completion times and int64 sequence numbers."""
        from repro_torch.device.runner import resolve_device
        dev = resolve_device(self.device)
        ctl.bind(self.idx)
        rank, res, caps, deps = (torch.from_numpy(a).to(dev) for a in
                                 _static_arrays(ctl, self.idx))
        comp, seqs = event_core(rank, res, caps, deps,
                                torch.from_numpy(durs).to(dev))
        return comp.cpu().numpy(), seqs.cpu().numpy().astype(np.int64)

    def run_lowered(self, ctl: CompiledTaskList,
                    jit: Optional[bool] = None) -> SimResult:
        seg = ctl.seg
        if seg is not None and seg.foldable:
            return self._np.run_lowered(ctl)
        if not self._use_core(jit) or ctl.n == 0:
            return self._np.run_lowered(ctl)
        durs = np.asarray(ctl.durs, dtype=np.float64)[None]
        comp, seqs = self._core(ctl, np.ascontiguousarray(durs))
        return self._postprocess(ctl, comp[0], seqs[0])

    def run_lowered_batch(self, ctl: CompiledTaskList,
                          durs_lanes: np.ndarray,
                          nbytes_lanes: Optional[np.ndarray] = None,
                          jit: Optional[bool] = None) -> List[SimResult]:
        """Run ``L`` message-size lanes of one lowered structure.

        ``durs_lanes`` is ``[L, n]`` float64 -- each lane's Hockney
        durations over the *same* task list (same ranks, resources,
        dependencies, block structure). ``nbytes_lanes`` optionally scales
        each lane's per-task payload bytes for the delivery records
        (defaults to ``ctl.nbytes`` for every lane). With the core on, all
        lanes go through one ``event_core`` call (one launch on cuda);
        otherwise each lane runs through the numpy engine on a per-lane
        rebind of the shared structure -- bit-identical either way."""
        durs_lanes = np.asarray(durs_lanes, dtype=np.float64)
        L, n = durs_lanes.shape
        if n != ctl.n:
            raise ValueError(f"durs_lanes has {n} tasks a lane, the list "
                             f"{ctl.n}")
        foldable = ctl.seg is not None and ctl.seg.foldable
        if not self._use_core(jit) or foldable or n == 0:
            out = []
            for lane in range(L):
                lane_ctl = copy.copy(ctl)
                lane_ctl.durs = durs_lanes[lane]
                if nbytes_lanes is not None:
                    lane_ctl.nbytes = np.asarray(nbytes_lanes[lane],
                                                 dtype=np.float64)
                lane_ctl._tpl = None      # template caches embed durations
                out.append(self._np.run_lowered(lane_ctl))
            return out
        comp, seqs = self._core(ctl, np.ascontiguousarray(durs_lanes))
        out = []
        for lane in range(L):
            nb = None if nbytes_lanes is None else nbytes_lanes[lane]
            out.append(self._postprocess(ctl, comp[lane], seqs[lane],
                                         nbytes=nb))
        return out

    # completion times -> SimResult ---------------------------------------
    def _postprocess(self, ctl: CompiledTaskList, comp: np.ndarray,
                     seqs: np.ndarray,
                     nbytes: Optional[np.ndarray] = None) -> SimResult:
        """Recover the reference bookkeeping from the core's outputs.

        Everything the numpy loop tracks event-by-event is a pure function
        of (completion time, admission seq) per task: deliveries are the
        tasks sorted by the event-heap key ``(time, seq)``; a node's finish
        is the time its coverage countdown (fresh lists) or block bitmap
        (lists with duplicate deliveries) first completes along that order;
        group finishes are per-group maxima."""
        n = ctl.n
        root = self.root
        tb = ctl.total_blocks
        order = np.lexsort((seqs, comp))
        t_ord = comp[order]
        d_ord = np.asarray(ctl.dst, dtype=np.int64)[order]
        nb = (np.asarray(ctl.nbytes, dtype=np.float64)
              if nbytes is None else np.asarray(nbytes, dtype=np.float64))
        deliveries = list(zip(t_ord.tolist(), nb[order].tolist()))

        node_finish = {root: 0.0}
        if ctl.all_fresh:
            # per-node countdown: group the completion order by node and
            # find where the within-node span cumsum first reaches the
            # total block count
            s_ord = np.asarray(ctl.spans, dtype=np.int64)[order]
            by_node = np.lexsort((np.arange(n), d_ord))
            dd = d_ord[by_node]
            cs = np.cumsum(s_ord[by_node])
            starts = np.searchsorted(dd, np.unique(dd))
            base = np.zeros(n, dtype=np.int64)
            base[starts] = np.concatenate(([0], cs[starts[1:] - 1]))
            within = cs - np.maximum.accumulate(base)
            hit = (within >= tb) & (within - s_ord[by_node] < tb)
            for k in np.nonzero(hit)[0]:
                v = int(dd[k])
                if v != root:
                    node_finish[v] = float(t_ord[by_node][k])
        else:
            # bitmap path: a block counts at its earliest delivery, a node
            # finishes when its last missing block lands
            lo = np.asarray([b[0] for b in ctl.blks], dtype=np.int64)[order]
            sp = np.asarray(ctl.spans, dtype=np.int64)[order]
            reps = np.repeat(np.arange(n), sp)
            off = np.arange(reps.size) - np.repeat(
                np.concatenate(([0], np.cumsum(sp)[:-1])), sp)
            blkid = lo[reps] + off
            key = d_ord[reps] * tb + blkid
            tt = t_ord[reps]
            earliest = np.full(ctl.num_nodes * tb, np.inf)
            np.minimum.at(earliest, key, tt)
            per_node = earliest.reshape(ctl.num_nodes, tb)
            covered = np.isfinite(per_node).all(axis=1)
            fins = per_node.max(axis=1)
            for v in range(ctl.num_nodes):
                if v != root and covered[v]:
                    node_finish[v] = float(fins[v])

        missing = [v for v in range(ctl.num_nodes) if v not in node_finish]
        assert not missing, \
            f"nodes {missing[:5]} never got the full message"

        gf: List[float] = []
        if any(g is not None for g in ctl.grps):
            group_last = {}
            for i in order:
                g = ctl.grps[i]
                if g is not None:
                    group_last[g] = float(comp[i])
            gf = [group_last[g] for g in sorted(group_last)]

        return SimResult(finish_time=max(node_finish.values()),
                         node_finish=node_finish, deliveries=deliveries,
                         group_finish=gf, started=n, completed=n)


def lower_baseline_lanes(topo: Topology, cm: ConflictModel, name: str,
                         root: int, sizes: Sequence[float],
                         ) -> Tuple[CompiledTaskList, np.ndarray,
                                    np.ndarray]:
    """Lower baseline ``name`` at each message size and stack the lanes.

    Verifies the lowered structure is size-invariant (true for the
    whole-message tree family and srda, whose task graphs do not depend on
    the payload; the chain family re-segments per size and is rejected) and
    returns ``(ctl, durs [L, n], nbytes [L, n])`` ready for
    ``KernelSim.run_lowered_batch``."""
    from repro_torch.core.baselines import lower_baseline

    ctls = [lower_baseline(topo, cm, name, root, s) for s in sizes]
    ctl0 = ctls[0]
    for c in ctls[1:]:
        same = (c.n == ctl0.n and c.rank == ctl0.rank
                and c.deps == ctl0.deps and c.dst == ctl0.dst
                and c.blks == ctl0.blks and c.res_ids == ctl0.res_ids)
        if not same:
            raise ValueError(
                f"baseline {name!r} does not keep one lowered structure "
                f"across message sizes; sweep it without lane batching")
    durs = np.asarray([c.durs for c in ctls], dtype=np.float64)
    nbytes = np.asarray([c.nbytes for c in ctls], dtype=np.float64)
    return ctl0, durs, nbytes
