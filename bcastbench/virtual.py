"""A cell on one card: the fabric's n nodes are n virtual devices of it
(``repro_torch``'s main path).

Set-up makes the plans warm (the cell's ``PlanStore`` under
``.cache/plans/``, then every root of the mix through the ``PlanServer``),
builds K1, builds each (root, size)'s executable and moves, makes the
payload pool on the card and runs every shape once, the largest first.
The window then serves one client in a closed loop: each request is the
prebuilt executable's ``ex.run(x)`` and a synchronize. It lasts
``--seconds`` and then to the end of its block, so each shape has the same
count in it. After the window the check compares, with the reference, the
answers the window kept and one check request of every shape made through
the same executables; and K1's counters with what the plans ask.
"""

from __future__ import annotations

import gc
import time
import traceback
from typing import Dict, List

import torch

from bcastbench import devtrace, harness, reference, traffic
from bcastbench.harness import RunRecord, Served, log


def build_topology(config: dict):
    from repro_torch.core import topology as T
    b = config["build"]
    return getattr(T, b["fn"])(*b.get("args", ()), **b.get("kwargs", {}))


def plan_store(cell):
    """The cell's ``PlanStore``, in ``.cache/plans/<config>`` beside the
    cell's files."""
    from repro_torch.core.planstore import PlanStore
    path = cell.base / ".cache" / "plans" / cell.config["name"]
    path.mkdir(parents=True, exist_ok=True)
    return PlanStore(str(path)), path


def run(cell, seed: int, seconds: float, trace: bool, t_start: float,
        device: str = "cuda") -> dict:
    """One run of ``cell``; returns the result line's fields and the
    checks (``harness.finish`` prints them)."""
    clock = harness.SetupClock(t_start)
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    with clock.phase("import_cuda"):
        from repro_torch import api
        from repro_torch.core.simconfig import DeviceConfig, SimConfig
        from repro_torch.device import round_step
        if cuda:
            torch.cuda.init()
            torch.zeros(1, device=dev)
    with clock.phase("k1_build"):
        if cuda:
            from repro_torch import nvcc
            nvcc.load("permute_rounds")
    config, mix = cell.config, cell.mix
    dtype = getattr(torch, config["payload_dtype"])
    esize = torch.empty((), dtype=dtype).element_size()
    gen = cell.generator()
    with clock.phase("plans"):
        topo = build_topology(config)
        n = topo.num_nodes
        roots = traffic.roots_of(mix, n)
        sizes = traffic.sizes_of(mix, esize)
        shapes = gen.shapes(mix, n, esize)
        store, store_path = plan_store(cell)
        model = api.compile(topo, store=store)
        for fut in model.server.prefetch_jobs(topo, roots).values():
            fut.result()
    with clock.phase("relabels"):
        for r in roots:
            model.plan(r)
    simcfg = SimConfig(device=DeviceConfig(device=device))
    exes = {}
    with clock.phase("executables"):
        for root, nbytes in shapes:
            ex = model.executable(root, nbytes, config=simcfg)
            ex.moves() if cuda else ex.tables()
            exes[(root, nbytes)] = ex
    log("[executables] sub-rounds by (root, bytes): " + ", ".join(
        f"{r}/{nb} {ex.num_subrounds}" for (r, nb), ex in exes.items()))
    pool_n = int(mix["pool"])
    with clock.phase("payloads"):
        pool = traffic.payload_pool(seed, sizes, pool_n, dev, dtype)
    out_bytes = (lambda nb: n * nb)
    first = harness.window_keeps(shapes, out_bytes, float(mix["keep_bytes"]))
    with clock.phase("warmup"):
        spare = harness.spare_blocks(dev, first, out_bytes)
        for shape in sorted(shapes, key=lambda s: -s[1]):
            exes[shape].run(pool[shape[1]][0])
            if cuda:
                torch.cuda.synchronize(dev)
        log(f"[memory] after the warm-up: {harness.memory(dev)}")
    keeper = harness.Keeper(first, spare)
    setup_s = clock.total()
    log(f"[keep] the window's first answer of {first} and its last")
    log(f"[setup] {setup_s:.3f} s: " + ", ".join(
        f"{k} {v:.3f}" for k, v in clock.phases.items()))
    log(f"[plans] store {store_path.name}: {harness.store_bytes(store_path)} "
        f"B on disk; server {model.server.stats.as_dict()}")

    # -- the window ----------------------------------------------------------
    block = gen.block(mix, n, esize)
    k1_before = (round_step.rounds_launches, round_step.subrounds)
    segs_before = harness.segments(dev)
    tracer = devtrace.Tracer(dev) if trace and cuda else None
    if tracer:
        tracer.start()
    served: List[Served] = []
    w0 = time.perf_counter()
    deadline = w0 + seconds
    for req in gen.stream(mix, seed, n, esize):
        ex = exes[(req.root, req.nbytes)]
        out, ok = None, True
        t0 = time.perf_counter()
        try:
            out = ex.run(pool[req.nbytes][req.slot])
            if cuda:
                torch.cuda.synchronize(dev)
        except Exception:                   # a failed request is counted
            traceback.print_exc()
            ok = False
        t1 = time.perf_counter()
        served.append(Served(root=req.root, nbytes=req.nbytes, t0=t0, t1=t1,
                             ok=ok, subrounds=ex.num_subrounds))
        last = t1 >= deadline and (req.index + 1) % block == 0
        keeper.offer(req, out, last)
        del out
        if last:
            break
    w1 = served[-1].t1
    dtrace = tracer.stop(w1) if tracer else None
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    log(f"[memory] at the window's close: {harness.memory(dev)}; segments "
        f"the allocator took from the card in the window: "
        f"{harness.segments(dev) - segs_before}")
    k1 = {"launches": round_step.rounds_launches - k1_before[0],
          "subrounds": round_step.subrounds - k1_before[1]}

    # -- the check -----------------------------------------------------------
    t_check = time.perf_counter()
    bad, copies, compared, failed_checks = 0, 0, set(), 0

    def judge(req_root, nbytes, slot, out):
        nonlocal bad, copies
        want = reference.expected_copy(seed, nbytes, slot, dev, dtype)
        bad += reference.bad_bytes(out, want, n)
        copies += n
        compared.add((req_root, nbytes))

    in_window = len(keeper.kept)
    while keeper.kept:
        req, out = keeper.kept.pop(0)
        judge(req.root, req.nbytes, req.slot, out)
        del out
    keeper.spare.clear()
    if cuda:
        torch.cuda.empty_cache()
    slots = harness.check_slots(seed, shapes, pool_n)
    for shape in shapes:
        try:
            out = exes[shape].run(pool[shape[1]][slots[shape]])
        except Exception:
            traceback.print_exc()
            failed_checks += 1
            continue
        judge(*shape, slots[shape], out)
        del out
    del exes, model, pool
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    done = [s for s in served if s.ok]
    planned = sum(s.subrounds for s in done)
    sent = {(s.root, s.nbytes) for s in served}
    checks: Dict[str, list] = {
        "bad_bytes": [bad, 0],
        "failed_requests": [len(served) - len(done) + failed_checks, 0],
        "unchecked_shapes": [len(sent - compared), 0],
    }
    if cuda:
        checks["k1_subround_gap"] = [abs(k1["subrounds"] - planned), 0]
        checks["k1_launch_gap"] = [abs(k1["launches"] - len(done)), 0]
    log(f"[k1] permute_rounds ran {k1['subrounds']} sub-rounds in "
        f"{k1['launches']} launches; the plans of the {len(done)} requests "
        f"ask {planned} sub-rounds in {len(done)} launches")
    for (root, nbytes), ms in sorted(_by_shape(done).items()):
        log(f"[shape] root {root} {nbytes} B: {len(ms)} requests, p50 "
            f"{harness.percentile(ms, 50):.3f} ms, p95 "
            f"{harness.percentile(ms, 95):.3f} ms")
    log(f"[check] {copies} copies compared with the reference: {in_window} "
        f"answers of the window ({len(served)} served) and "
        f"{len(shapes) - failed_checks} check requests after it, in "
        f"{time.perf_counter() - t_check:.3f} s; {bad} bytes differ")
    rec = RunRecord(cell=cell.name, n=n, setup_s=setup_s,
                    setup_phases=dict(clock.phases), served=served,
                    window_s=w1 - w0, k1=k1, trace=dtrace)
    device_info = {"platform": "gpu" if cuda else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
                   "count": 1, "memory_peak_bytes": int(peak)}
    return dict(rec=rec, device=device_info, checks=checks,
                label=_labeler(served))


def _by_shape(done: List[Served]) -> Dict[tuple, List[float]]:
    """ms of the requests of each (root, size)."""
    out: Dict[tuple, List[float]] = {}
    for s in done:
        out.setdefault((s.root, s.nbytes), []).append(s.seconds * 1e3)
    return out


def _labeler(served: List[Served]):
    """What the host was doing at a time of the window: running a request
    (pack, K1's launch, unpack, the synchronize), or the harness's own work
    between requests."""
    import bisect
    starts = [s.t0 for s in served]

    def label(t: float) -> str:
        i = bisect.bisect_right(starts, t) - 1
        return "run" if i >= 0 and t < served[i].t1 else "harness"
    return label
