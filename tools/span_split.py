"""Split a benchmark cell's broadcasts by the port's spans, on the card.

    python3 tools/span_split.py --workload mesh2d-256.large --seed 7 \\
        --seconds 10 [--out split.json]

Builds the cell of ``BENCHMARK.json`` as ``bcastbench/virtual.py`` does
(the plan store, every root made warm, each (root, size)'s executable and
moves, the payload pool, one warm-up request a shape), with
``repro_torch.spans`` recording from the plans on. Then it serves the
cell's closed loop in six windows of ``--seconds`` each, ending on a whole
block of the mix's shapes: spans off, spans on, spans on under
``torch.profiler``, and the same three back in reverse order; a profiler
session over one block comes first, untimed.

It reports, as one JSON line on stdout (and in ``--out``):

* ``setup``: the set-up's phases, and ``lowering_s``, the seconds of the
  outermost ``lower.*`` spans, beside the ``executables`` phase that holds
  them, and ``phase_pass_ms``, each plan's ``lower.phases`` (K1's phase
  table); the warm-up's host seconds by span;
* ``windows``: each window's p50, p95, payload rate and the host time of
  ``ExecutablePlan.run`` up to its return (before the synchronize), the
  window's growth of ``runner.unpack_launches`` and
  ``runner.unpack_bytes`` (the ``unpack_rows`` kernel's launches, and the
  bytes they read and wrote), of ``runner.inplace_runs`` and
  ``runner.staged_runs`` (the requests K1 ran in place, writing into the
  stacked output, and through the staging buffer), by shape the bytes
  ``unpack_rows`` moved a request (``unpack_bytes_by_shape``: in place
  only the tails), and by shape the share of K1's
  ``round_step.moved_bytes`` that moves reading or writing a relay row
  moved (``round_step.relay_bytes``; ``k1_relay_pct``); K1's steps over
  its sub-rounds, ``round_step.phases`` over ``round_step.subrounds``, in
  the window and by shape (``k1_phase_pct``, ``k1_phase_pct_by_shape``:
  how far running by dependency phase cuts the grid barriers);
* ``traced``: each device operation of the traced windows joined to the
  CUDA runtime call that launched it (the profiler's correlation ids) and
  so to the innermost span holding the launch: device ms a request under
  ``runner.pack``, ``runner.cycles`` and ``runner.unpack``, the device
  seconds no span claims, the device's idle time by the span it falls in
  (split by overlap), K1's ``round_step.moved_bytes`` against the least
  bytes (``bcastbench.roofline``) and against the plans' own count, with
  ``round_step.relay_bytes`` beside it, ``runner.unpack``'s share of the
  HBM peak on the bytes ``unpack_rows`` moved, by shape
  (``unpack_hbm_pct``, with the window's in-place and staged counts and
  ``unpack_bytes_by_shape`` beside it), the host microseconds from a
  request's start to the runtime call that launched its K1
  (``k1_launch_us_p50``, ``k1_launch_us_mean``), and the readings the
  benchmark takes by kernel name beside them;
* ``span_ns``: the host cost of one span, off and on.

Times come from the profiler's clock. ``bcastbench.devtrace.Tracer`` ties
it to ``time.perf_counter`` once, by the device start of a marker fill
launched at a known time; this tool ties the runtime call that launched
the marker, and then the end of each request's synchronize, since a launch
has to be placed inside spans of tens of microseconds and the two clocks
drift apart over a window (``tie_drift_us``). ``marker_tie_us`` is the
marker's device start less its own launch, by which the device-start tie
places every launch early.

It needs an NVIDIA GPU and exits with 2 without one.
"""

from __future__ import annotations

import argparse
import bisect
import collections
import json
import statistics
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

T_START = time.perf_counter()
ROOT = Path(__file__).resolve().parents[1]
for _p in (str(ROOT), str(ROOT / "src")):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import torch  # noqa: E402

from bcastbench import (devtrace, harness, manifest, roofline,  # noqa: E402
                        traffic, virtual)
from repro_torch import spans  # noqa: E402
from repro_torch.device import round_step, runner  # noqa: E402

REQUEST_PARTS = ("runner.pack", "runner.cycles", "runner.unpack")
MODES = ("off", "spans", "traced", "traced", "spans", "off")
SMOOTH = 4            # requests on each side whose clock offsets are pooled


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


# -- the device's side, with each operation's launch --------------------------

class LaunchTracer:
    """A ``torch.profiler`` window over the CUDA activity (kernels, copies,
    fills and the runtime calls that launch them), tied to
    ``perf_counter`` by a marker fill as ``bcastbench.devtrace.Tracer``
    ties it."""

    def __init__(self, device: torch.device):
        self.device = device
        self.prof, self.mark = None, 0.0

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile
        marker = torch.zeros(1, device=self.device)
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.__enter__()
        torch.cuda.synchronize(self.device)
        self.mark = time.perf_counter()
        marker.fill_(1.0)
        torch.cuda.synchronize(self.device)

    def stop(self) -> dict:
        torch.cuda.synchronize(self.device)
        self.prof.__exit__(None, None, None)
        out = launches_of(self.prof.profiler.kineto_results.events())
        self.prof = None
        return out


def launches_of(events) -> dict:
    """The device operations of a profiler window on the profiler's clock
    (ns), in order: each ``(name, start, duration, launch)``, ``launch``
    the start of the runtime call whose id it carries (None where none
    does), the first the marker fill; the ``cudaStreamSynchronize`` calls
    (the requests') as ``(start, end)``; the runtime calls by name; and how many operations
    matched by which id."""
    dev, calls, syncs = [], {}, []
    names: Dict[str, int] = collections.Counter()
    for e in events:
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            dev.append((e.start_ns(), e.duration_ns(), e.name(),
                        e.correlation_id(), e.linked_correlation_id()))
        elif e.name().startswith("cu") and e.correlation_id():
            c = e.correlation_id()
            calls[c] = min(calls.get(c, e.start_ns()), e.start_ns())
            names[e.name()] += 1
            if e.name() == "cudaStreamSynchronize":
                syncs.append((e.start_ns(), e.start_ns() + e.duration_ns()))
    dev.sort()
    matched = collections.Counter()

    def launch(corr: int, linked: int) -> Optional[int]:
        for key, c in (("correlation_id", corr),
                       ("linked_correlation_id", linked)):
            if c and c in calls:
                matched[key] += 1
                return calls[c]
        matched["none"] += 1
        return None

    ops = [(name, s, d, launch(c, lc)) for s, d, name, c, lc in dev]
    return {"ops": ops, "syncs": sorted(syncs), "calls": dict(names),
            "matched": dict(matched)}


class Clock:
    """The profiler's clock (ns) onto ``perf_counter``: each time shifted by
    the offset of the last anchor ``(ns, perf)`` at or before it (the
    first anchor's before them all)."""

    def __init__(self, anchors: List[tuple]):
        anchors = sorted(anchors)
        self.base = anchors[0][0]
        self.ns = [a for a, _ in anchors]
        self.off = [p - (a - self.base) * 1e-9 for a, p in anchors]

    def __call__(self, ns: Optional[int]) -> Optional[float]:
        if ns is None:
            return None
        i = max(bisect.bisect_right(self.ns, ns) - 1, 0)
        return (ns - self.base) * 1e-9 + self.off[i]

    @property
    def drift_us(self) -> float:
        """How far the first anchor's offset is from the last's."""
        return (self.off[-1] - self.off[0]) * 1e6


def on_host(raw: dict, mark: float, served: List[dict]) -> dict:
    """``raw``'s operations after the marker on ``perf_counter``, as
    ``(name, start, seconds, launch)``. The marker's launch is tied to
    ``mark``, and each request's synchronize to the harness's reads around
    it, so a drift between the two clocks does not build up over the
    window: the call starts after ``t_ret`` and ends before ``t1``, which
    bounds the offset between the clocks from below and above. The bounds
    of a request and its neighbours (``SMOOTH`` on each side) are
    intersected, so a host stall on one side of one call moves no tie, and
    the middle of what is left is taken (of each request's own middles,
    the median, where the bounds do not meet). Without a marker launch or
    one stream synchronize a request, the marker's device start alone is
    tied to ``mark``."""
    _, m_start, _, m_launch = raw["ops"][0]
    mine = raw["syncs"]
    if m_launch is not None and len(mine) == len(served) and all(
            (s1 - s0) * 1e-9 <= r["t1"] - r["t_ret"]
            for (s0, s1), r in zip(mine, served)):
        lo = [r["t_ret"] - (s0 - m_launch) * 1e-9
              for (s0, _), r in zip(mine, served)]
        hi = [r["t1"] - (s1 - m_launch) * 1e-9
              for (_, s1), r in zip(mine, served)]
        anchors = [(m_launch, mark)]
        for k, (_, s1) in enumerate(mine):
            near = slice(max(0, k - SMOOTH), k + SMOOTH + 1)
            low, high = max(lo[near]), min(hi[near])
            off = 0.5 * (low + high) if low <= high else statistics.median(
                0.5 * (a + b) for a, b in zip(lo[near], hi[near]))
            anchors.append((s1, (s1 - m_launch) * 1e-9 + off))
    else:
        anchors = [(m_start, mark)]
    clock = Clock(anchors)
    ops = [(name, clock(s), d * 1e-9, clock(launch))
           for name, s, d, launch in raw["ops"][1:]]
    return {"ops": ops, "anchors": len(anchors),
            "tie_drift_us": clock.drift_us,
            "marker_tie_us": None if m_launch is None
            else (m_start - m_launch) * 1e-3}


def split(ops: List[tuple], window: List[spans.Span], served: List[dict],
          start: float, end: float) -> dict:
    """The device operations of one traced window by the span that launched
    them, and its idle time by the span it falls in."""
    runs = [s for s in window if s.name == "bcast.run"]
    if len(runs) != len(served):
        raise RuntimeError(f"{len(runs)} bcast.run spans for {len(served)} "
                           f"requests")
    # the harness's request (call to synchronize) as a span around each run
    reqs = [spans.Span("run", r["t0"], r["t1"], -1 - i, 0, s.request)
            for i, (r, s) in enumerate(zip(served, runs))]
    tl = spans.Timeline(window + reqs)
    names = {s.id: s.name for s in window + reqs}
    by_id, unclaimed = spans.attribute(tl, [(t, d) for _, _, d, t in ops])
    by_name: Dict[str, float] = collections.Counter()
    for sid, sec in by_id.items():
        by_name[names[sid]] += sec
    req_of = {s.id: k for k, s in enumerate(runs)}
    per_shape: Dict[str, Dict[str, float]] = {}
    for s in window:
        if s.name in REQUEST_PARTS and s.id in by_id:
            k = req_of[s.parent]
            shape = f"{served[k]['root']}/{served[k]['nbytes']}"
            d = per_shape.setdefault(shape, collections.Counter())
            d[s.name] += by_id[s.id]
            d["requests"] += s.name == "runner.pack"
    req_tl = spans.Timeline(reqs)

    def in_request(t: Optional[float]) -> bool:
        return t is not None and req_tl.at(t) is not None

    busy = devtrace._merged([(n, t, d) for n, t, d, _ in ops], start, end)
    busy_req = sum(d for n, t, d, launch in ops if in_request(t))
    lost_req = sum(d for n, t, d, launch in ops if in_request(t) and (
        launch is None or tl.at(launch) is None
        or tl.at(launch).name == "run"))
    k1_named = sum(d for n, t, d, _ in ops if "permute_rounds" in n)
    to_k1 = [(launch - req_tl.at(launch).t0) * 1e6
             for n, t, d, launch in ops if "permute_rounds" in n
             and launch is not None and req_tl.at(launch) is not None]
    runner_named = sum(d for n, t, d, _ in ops if in_request(t)
                       and "permute_rounds" not in n)
    gaps, t = [], start
    for s, e in busy:
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if end > t:
        gaps.append((t, end))
    idle_by: Dict[str, float] = collections.Counter()
    idle_mid: Dict[str, float] = collections.Counter()
    for a, b in gaps:
        for s, sec in tl.overlap(a, b):
            idle_by[s.name if s else "harness"] += sec
        s = tl.at(0.5 * (a + b))
        idle_mid[s.name if s else "harness"] += b - a
    n = len(runs)
    in_run = sum(v for k, v in idle_by.items() if k not in ("harness",
                                                            "run"))
    return {
        "requests": n,
        "dev_ms": {k: by_name.get(k, 0.0) / n * 1e3 for k in
                   REQUEST_PARTS + ("bcast.run", "run")},
        "dev_s_by_span": dict(by_name),
        "unclaimed_s": unclaimed,
        "unclaimed_in_requests_s": lost_req,
        "busy_in_requests_s": busy_req,
        "k1_named_s": k1_named,
        "runner_named_ms": runner_named / n * 1e3,
        "busy_s": sum(e - s for s, e in busy),
        "window_s": end - start,
        "idle_by_span_s": dict(idle_by),
        "idle_by_midpoint_s": dict(idle_mid),
        "run_idle_us": in_run / n * 1e6,
        "k1_launch_us_p50": harness.percentile(to_k1, 50) if to_k1 else None,
        "k1_launch_us_mean": statistics.fmean(to_k1) if to_k1 else None,
        "per_shape_dev_ms": {k: {p: v[p] / v["requests"] * 1e3
                                 for p in REQUEST_PARTS}
                             for k, v in per_shape.items() if v["requests"]},
    }


# -- the cell ----------------------------------------------------------------

def build(cell, seed: int, device: torch.device) -> dict:
    """Set-up as ``bcastbench/virtual.py`` makes it, spans recording."""
    from repro_torch import api
    from repro_torch.core.simconfig import DeviceConfig, SimConfig
    cuda = device.type == "cuda"
    clock = harness.SetupClock(T_START)
    with clock.phase("import_cuda"):
        if cuda:
            torch.cuda.init()
            torch.zeros(1, device=device)
    with clock.phase("k1_build"):
        if cuda:
            from repro_torch import nvcc
            nvcc.load("permute_rounds")
    config, mix = cell.config, cell.mix
    dtype = getattr(torch, config["payload_dtype"])
    esize = torch.empty((), dtype=dtype).element_size()
    gen = cell.generator()
    spans.start()
    with clock.phase("plans"):
        topo = virtual.build_topology(config)
        n = topo.num_nodes
        sizes = traffic.sizes_of(mix, esize)
        shapes = gen.shapes(mix, n, esize)
        store, _ = virtual.plan_store(cell)
        model = api.compile(topo, store=store)
        for fut in model.server.prefetch_jobs(
                topo, traffic.roots_of(mix, n)).values():
            fut.result()
    with clock.phase("relabels"):
        for r in traffic.roots_of(mix, n):
            model.plan(r)
    simcfg = SimConfig(device=DeviceConfig(device=device.type))
    exes = {}
    with clock.phase("executables"):
        for root, nbytes in shapes:
            ex = model.executable(root, nbytes, config=simcfg)
            ex.moves() if cuda else ex.tables()
            exes[(root, nbytes)] = ex
    with clock.phase("payloads"):
        pool = traffic.payload_pool(seed, sizes, int(mix["pool"]), device,
                                    dtype)
    with clock.phase("warmup"):
        for shape in sorted(shapes, key=lambda s: -s[1]):
            exes[shape].run(pool[shape[1]][0])
            if cuda:
                torch.cuda.synchronize(device)
    recorded = spans.stop()
    lower = {s.id: s for s in recorded if s.name.startswith("lower.")}
    outer = [s for s in lower.values() if s.parent not in lower]
    by_name: Dict[str, float] = collections.Counter()
    for s in recorded:
        by_name[s.name] += s.seconds
    bytes_per = {}
    for shape, ex in exes.items():
        x = pool[shape[1]][0]
        lay = ex.lowered.placement(x).lay
        if cuda:
            mv = ex.moves()
            bytes_per[shape] = mv.moved_bytes(0, mv.num_subrounds,
                                              lay.row_bytes)
    return dict(model=model, exes=exes, pool=pool, gen=gen, n=n,
                esize=esize, mix=mix, bytes_per=bytes_per, setup={
                    "setup_s": clock.total(), "phases": dict(clock.phases),
                    "lowering_s": sum(s.seconds for s in outer),
                    "phase_pass_ms": [s.seconds * 1e3 for s in recorded
                                      if s.name == "lower.phases"],
                    "host_s_by_span": dict(by_name),
                    "warmup_requests": sum(s.name == "bcast.run"
                                           for s in recorded)})


def serve(st: dict, seed: int, seconds: float, device: torch.device
          ) -> List[dict]:
    """One window of the closed loop, ending on a whole block."""
    gen, mix, n, esize = st["gen"], st["mix"], st["n"], st["esize"]
    block = gen.block(mix, n, esize)
    cuda = device.type == "cuda"
    # a stream's synchronize is one runtime call with little Python around
    # it, so the reads before and after it bound its time on the host
    stream = torch.cuda.current_stream(device) if cuda else None
    out: List[dict] = []
    deadline = time.perf_counter() + seconds
    for req in gen.stream(mix, seed, n, esize):
        ex = st["exes"][(req.root, req.nbytes)]
        k1 = (round_step.moved_bytes, round_step.relay_bytes,
              runner.unpack_bytes, round_step.subrounds, round_step.phases)
        t0 = time.perf_counter()
        y = ex.run(st["pool"][req.nbytes][req.slot])
        t_ret = time.perf_counter()
        if cuda:
            stream.synchronize()
        t1 = time.perf_counter()
        del y
        out.append({"root": req.root, "nbytes": req.nbytes, "t0": t0,
                    "t_ret": t_ret, "t1": t1,
                    "moved": round_step.moved_bytes - k1[0],
                    "relay": round_step.relay_bytes - k1[1],
                    "unpack": runner.unpack_bytes - k1[2],
                    "subrounds": round_step.subrounds - k1[3],
                    "phases": round_step.phases - k1[4]})
        if t1 >= deadline and (req.index + 1) % block == 0:
            return out
    return out


def summary(served: List[dict]) -> dict:
    ms = [(r["t1"] - r["t0"]) * 1e3 for r in served]
    host = [(r["t_ret"] - r["t0"]) * 1e6 for r in served]
    window = served[-1]["t1"] - served[0]["t0"]
    return {"requests": len(served),
            "p50_ms": harness.percentile(ms, 50),
            "p95_ms": harness.percentile(ms, 95),
            "rate_gbps": sum(r["nbytes"] for r in served) / window / 1e9,
            "run_host_us_p50": harness.percentile(host, 50),
            "run_host_us_mean": statistics.fmean(host)}


def span_cost(count: int = 200_000) -> dict:
    """ns a ``with span(...)`` block costs, off and on."""
    out = {}
    for mode in ("off", "on"):
        if mode == "on":
            spans.start()
        t0 = time.perf_counter()
        for _ in range(count):
            with spans.span("x"):
                pass
        out[mode] = (time.perf_counter() - t0) / count * 1e9
        spans.stop()
    return out


def relay_pct(served: List[dict]) -> Dict[str, float]:
    """By shape ``root/nbytes``: the share of K1's moved bytes that moves
    reading or writing a relay row moved, %, from the counters' growth in
    each request."""
    moved: Dict[str, int] = collections.Counter()
    relay: Dict[str, int] = collections.Counter()
    for r in served:
        shape = f"{r['root']}/{r['nbytes']}"
        moved[shape] += r["moved"]
        relay[shape] += r["relay"]
    return {k: 100.0 * relay[k] / v for k, v in moved.items() if v}


def phase_pct(served: List[dict]) -> Dict[str, float]:
    """By shape ``root/nbytes``, and over all under ``"all"``: K1's steps
    over its sub-rounds, %, from ``round_step.phases`` and
    ``round_step.subrounds``' growth in each request."""
    steps: Dict[str, int] = collections.Counter()
    subs: Dict[str, int] = collections.Counter()
    for r in served:
        for shape in (f"{r['root']}/{r['nbytes']}", "all"):
            steps[shape] += r["phases"]
            subs[shape] += r["subrounds"]
    return {k: 100.0 * steps[k] / v for k, v in subs.items() if v}


def unpack_by_shape(served: List[dict]) -> Dict[str, float]:
    """By shape ``root/nbytes``: the bytes ``unpack_rows`` read and wrote a
    request, from ``runner.unpack_bytes``' growth in each."""
    moved: Dict[str, int] = collections.Counter()
    count: Dict[str, int] = collections.Counter()
    for r in served:
        shape = f"{r['root']}/{r['nbytes']}"
        moved[shape] += r["unpack"]
        count[shape] += 1
    return {k: moved[k] / count[k] for k in count}


def unpack_hbm_pct(per_shape: Dict[str, Dict[str, float]],
                   moved: Dict[str, float]) -> Dict[str, float]:
    """By shape ``root/nbytes``: the bytes ``unpack_rows`` read and wrote a
    request (``moved``, from ``unpack_by_shape``) at the HBM peak over
    ``runner.unpack``'s device ms a request, %."""
    out = {}
    for shape, ms in per_shape.items():
        dev_s = ms["runner.unpack"] / 1e3
        total = moved.get(shape, 0)
        if dev_s > 0 and total:
            out[shape] = 100.0 * roofline.least_seconds(total) / dev_s
    return out


def measure(cell, seed: int, seconds: float, device: torch.device) -> dict:
    st = build(cell, seed, device)
    log(f"[setup] {json.dumps(st['setup'])}")
    if device.type == "cuda":
        # a process's first profiler session keeps a clock that drifts
        # from perf_counter by up to milliseconds over a window, later ones
        # by about 0.1 ms: spend the first on one block of requests
        warm = LaunchTracer(device)
        warm.start()
        serve(st, seed - 1, 0.0, device)
        warm.stop()
    windows, traced = [], []
    for i, mode in enumerate(MODES):
        tracer = None
        if mode != "off":
            spans.start()
        if mode == "traced" and device.type == "cuda":
            tracer = LaunchTracer(device)
            tracer.start()
        unpack0 = (runner.unpack_launches, runner.unpack_bytes,
                   runner.inplace_runs, runner.staged_runs)
        served = serve(st, seed + i, seconds, device)
        moved = sum(r["moved"] for r in served)
        dev = tracer.stop() if tracer else None
        recorded = spans.stop() if mode != "off" else []
        row = dict(mode=mode, **summary(served),
                   unpack_launches=runner.unpack_launches - unpack0[0],
                   unpack_bytes=runner.unpack_bytes - unpack0[1],
                   inplace_runs=runner.inplace_runs - unpack0[2],
                   staged_runs=runner.staged_runs - unpack0[3],
                   unpack_bytes_by_shape=unpack_by_shape(served),
                   k1_relay_pct=relay_pct(served))
        pct = phase_pct(served)
        row.update(k1_phase_pct=pct.pop("all", None),
                   k1_phase_pct_by_shape=pct)
        windows.append(row)
        log(f"[window {i}] {json.dumps(row)}")
        if dev is None:
            continue
        w0, w1 = served[0]["t0"], served[-1]["t1"]
        host = on_host(dev, tracer.mark, served)
        got = split(host["ops"], recorded, served, tracer.mark, w1)
        least = sum(roofline.least_bytes(st["n"], r["nbytes"])
                    for r in served)
        planned = sum(st["bytes_per"][(r["root"], r["nbytes"])]
                      for r in served)
        k1 = got["k1_named_s"]
        got.update(
            window_start=w0, calls=dev["calls"], matched=dev["matched"],
            marker_tie_us=host["marker_tie_us"], anchors=host["anchors"],
            tie_drift_us=host["tie_drift_us"], moved_bytes=moved,
            relay_bytes=sum(r["relay"] for r in served),
            planned_bytes=planned, least_bytes=least,
            k1_useful_pct=100.0 * least / moved if moved else None,
            k1_roofline_pct=100.0 * roofline.least_seconds(least) / k1
            if k1 else None,
            k1_hbm_pct=100.0 * roofline.least_seconds(moved) / k1
            if k1 else None,
            unpack_hbm_pct=unpack_hbm_pct(got["per_shape_dev_ms"],
                                          row["unpack_bytes_by_shape"]),
            inplace_runs=row["inplace_runs"], staged_runs=row["staged_runs"],
            unpack_bytes_by_shape=row["unpack_bytes_by_shape"])
        traced.append(got)
        log(f"[traced {i}] {json.dumps(got)}")
    return {"cell": cell.name, "seed": seed, "seconds": seconds,
            "card": harness.power_limit() if device.type == "cuda"
            else device.type,
            "setup": st["setup"], "windows": windows, "traced": traced,
            "span_ns": span_cost()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--out", type=Path)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        log("[device] needs an NVIDIA GPU; torch.cuda.is_available() is "
            "False")
        return 2
    cell = manifest.find_cell(args.workload, root=ROOT)
    res = measure(cell, args.seed, args.seconds, torch.device("cuda"))
    line = json.dumps(res)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
