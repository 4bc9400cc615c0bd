"""Warm broadcast-plan service: orbit-canonicalizing lookups over a
long-lived in-memory cache.

The paper's workflow (§2.6) builds a plan offline and reuses it for any
message size; a serving tier turns that into a query interface: "what is
the broadcast schedule and predicted time for (fabric, root, nbytes)?".
``PlanServer`` answers those queries from two cache levels:

  * **L1 — responses**, LRU keyed ``(fingerprint, root, mode, nbytes)``:
    the fully evaluated answer (selected candidate, m_opt, predicted
    time). Repeat queries cost a dict lookup.
  * **L2 — plans**, LRU keyed ``(fingerprint, root, mode)``: the
    ``BBSPlan`` that answers *any* nbytes for that root. Lookups are
    **orbit-canonicalizing**: the requested root is mapped to its orbit
    representative under the fabric's recorded automorphism group, only
    the representative's plan is ever *built* (LP + probe + cycle scan),
    and other roots in the orbit are served by relabeling it through a
    permutation witness — bit-identical to building at that root, at
    O(tasks) cost (see ``repro_torch.core.symmetry``).

Builds are **single-flight**: concurrent requests for the same canonical
plan share one build via a future; the duplicates block on it instead of
re-running the LP. Builds on the miss path run one at a time (plan
construction is CPU-bound and shares compiled-topology state), but each
miss can also be scheduled off-thread with ``prefetch`` and collected
later. An optional ``PlanStore`` backs L2 with the on-disk packed
artifacts, so a warm directory survives process restarts.

Every request updates hit/miss/build counters (``CacheStats``); the
``plan_cache`` simbench cell and the CI smoke gate on them.

    python -m repro_torch.launch.planserver --smoke
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Dict, Optional, Tuple

from repro_torch.core.intersection import FULL_DUPLEX
from repro_torch.core.routing import topology_fingerprint
from repro_torch.core.topology import Topology


@dataclasses.dataclass
class CacheStats:
    """Serving counters. ``hit_rate`` is the warm-cache rate the smoke and
    the ``plan_cache`` bench cell gate on: the fraction of requests that
    did *not* trigger a plan build (L1 hits, warm-plan hits, and relabels
    from a warm representative all count as hits — none of them pay the
    LP/probe cost)."""

    requests: int = 0
    l1_hits: int = 0          # response served straight from the L1 LRU
    plan_hits: int = 0        # plan already warm (canonical or relabeled)
    relabels: int = 0         # orbit relabels performed (then cached)
    builds: int = 0           # full plan builds (the expensive path)
    build_seconds: float = 0.0
    relabel_seconds: float = 0.0
    evictions: int = 0

    @property
    def hit_rate(self) -> float:
        if self.requests == 0:
            return 0.0
        return 1.0 - self.builds / self.requests

    def as_dict(self) -> Dict[str, float]:
        d = dataclasses.asdict(self)
        d["hit_rate"] = self.hit_rate
        return d


class _LRU:
    """Minimal thread-compatible LRU (caller holds the server lock)."""

    def __init__(self, capacity: int):
        self.capacity = capacity
        self._d: "collections.OrderedDict" = collections.OrderedDict()

    def get(self, key):
        try:
            self._d.move_to_end(key)
            return self._d[key]
        except KeyError:
            return None

    def put(self, key, value) -> int:
        """Insert and return the number of evictions performed."""
        self._d[key] = value
        self._d.move_to_end(key)
        evicted = 0
        while len(self._d) > self.capacity:
            self._d.popitem(last=False)
            evicted += 1
        return evicted

    def __len__(self):
        return len(self._d)

    def __contains__(self, key):
        return key in self._d


class PlanServer:
    """Long-lived broadcast-plan service (see module docstring).

    ``plan_capacity`` bounds L2 (plans are the heavy objects);
    ``response_capacity`` bounds L1. ``store`` optionally backs canonical
    builds with on-disk packed artifacts."""

    def __init__(self, store=None, plan_capacity: int = 256,
                 response_capacity: int = 4096,
                 mode: str = FULL_DUPLEX):
        self.store = store
        self.default_mode = mode
        self.stats = CacheStats()
        self._lock = threading.Lock()          # caches + stats + inflight
        self._build_lock = threading.Lock()    # serializes plan builds
        self._plans = _LRU(plan_capacity)      # (fp, root, mode) -> BBSPlan
        self._responses = _LRU(response_capacity)
        self._inflight: Dict[tuple, Future] = {}
        self._topos: Dict[str, Topology] = {}  # fp -> registered fabric
        self._pool: Optional[ThreadPoolExecutor] = None

    # -- registration ---------------------------------------------------------

    def register(self, topo: Topology) -> str:
        """Make ``topo`` servable; returns its content fingerprint (the
        handle requests address it by)."""
        fp = topology_fingerprint(topo)
        with self._lock:
            self._topos[fp] = topo
        return fp

    def _resolve(self, topo) -> Tuple[str, Topology]:
        if isinstance(topo, str):
            with self._lock:
                try:
                    return topo, self._topos[topo]
                except KeyError:
                    raise KeyError(
                        f"unknown fabric fingerprint {topo!r}; register the "
                        f"topology first") from None
        return self.register(topo), topo

    # -- the serving entry points ---------------------------------------------

    def request(self, topo, root: int, nbytes: float,
                mode: Optional[str] = None) -> Tuple[float, dict]:
        """Serve one query: predicted broadcast time + selection info for
        broadcasting ``nbytes`` from ``root``. ``topo`` is a ``Topology``
        or a registered fingerprint."""
        mode = mode or self.default_mode
        fp, topo = self._resolve(topo)
        rkey = (fp, root, mode, float(nbytes))
        with self._lock:
            self.stats.requests += 1
            hit = self._responses.get(rkey)
            if hit is not None:
                self.stats.l1_hits += 1
                return hit
        plan = self._plan_for(fp, topo, root, mode)
        from repro_torch.core.bbs import broadcast_time
        t, info = broadcast_time(plan, nbytes)
        with self._lock:
            self.stats.evictions += self._responses.put(rkey, (t, info))
        return t, info

    def plan(self, topo, root: int, mode: Optional[str] = None):
        """Return the (possibly relabeled) ``BBSPlan`` for (topo, root)."""
        mode = mode or self.default_mode
        fp, topo = self._resolve(topo)
        with self._lock:
            self.stats.requests += 1
        return self._plan_for(fp, topo, root, mode)

    def prefetch(self, topo, root: int,
                 mode: Optional[str] = None) -> Future:
        """Schedule the plan build/relabel off-thread; returns a future
        resolving to the plan. Duplicate prefetches of the same canonical
        plan coalesce onto the in-flight build."""
        mode = mode or self.default_mode
        fp, topo = self._resolve(topo)
        with self._lock:
            if self._pool is None:
                self._pool = ThreadPoolExecutor(
                    max_workers=1, thread_name_prefix="planserver")
            pool = self._pool
        return pool.submit(self._plan_for, fp, topo, root, mode)

    def prefetch_jobs(self, topo, jobs_or_roots,
                      mode: Optional[str] = None) -> Dict[int, Future]:
        """Warm the plan caches for a whole workload before its jobs start
        arriving: deduplicate the jobs' roots to their orbit-canonical
        representatives (one build covers every root in an orbit — the
        non-canonical roots are O(tasks) relabels at request time) and
        ``prefetch`` each representative once. ``jobs_or_roots`` is any
        iterable of ints or of objects with a ``root`` attribute (e.g.
        ``repro_torch.workload.BroadcastJob``). Returns ``{canonical_root:
        Future}`` — the workload engine collects them before admission so
        plan-build latency never counts as queueing delay."""
        mode = mode or self.default_mode
        fp, topo = self._resolve(topo)
        aut = topo.automorphisms()
        canon = {aut.canonical_root(int(getattr(it, "root", it))): None
                 for it in jobs_or_roots}
        return {c: self.prefetch(fp, c, mode) for c in canon}

    # -- internals ------------------------------------------------------------

    def _plan_for(self, fp: str, topo: Topology, root: int, mode: str):
        pkey = (fp, root, mode)
        with self._lock:
            plan = self._plans.get(pkey)
            if plan is not None:
                self.stats.plan_hits += 1
                return plan
        aut = topo.automorphisms()
        canon = aut.canonical_root(root)
        canon_plan = self._canonical_plan(fp, topo, canon, mode)
        if canon == root:
            return canon_plan
        t0 = time.perf_counter()
        plan = canon_plan.relabel(aut.witness(root))
        dt = time.perf_counter() - t0
        with self._lock:
            self.stats.relabels += 1
            self.stats.relabel_seconds += dt
            self.stats.evictions += self._plans.put(pkey, plan)
        return plan

    def _canonical_plan(self, fp: str, topo: Topology, canon: int,
                        mode: str):
        """Warm path: L2 lookup. Miss path: single-flight build — the first
        requester creates the in-flight future and builds (serialized by
        the build lock); duplicates wait on the future."""
        ckey = (fp, canon, mode)
        while True:
            with self._lock:
                plan = self._plans.get(ckey)
                if plan is not None:
                    self.stats.plan_hits += 1
                    return plan
                fut = self._inflight.get(ckey)
                if fut is None:
                    fut = Future()
                    self._inflight[ckey] = fut
                    mine = True
                else:
                    mine = False
            if not mine:
                return fut.result()     # single-flight: ride the builder
            try:
                plan, build_s = self._build(topo, canon, mode)
            except BaseException as exc:
                with self._lock:
                    self._inflight.pop(ckey, None)
                fut.set_exception(exc)
                raise
            with self._lock:
                self.stats.builds += 1
                self.stats.build_seconds += build_s
                self.stats.evictions += self._plans.put(ckey, plan)
                self._inflight.pop(ckey, None)
            fut.set_result(plan)
            return plan

    def _build(self, topo: Topology, root: int, mode: str):
        with self._build_lock:
            t0 = time.perf_counter()
            if self.store is not None:
                plans, _, _ = self.store.get_or_build_packed(
                    topo, roots=[root], mode=mode)
                plan = plans[root]
            else:
                from repro_torch.core.bbs import build_plan
                plan = build_plan(topo, root=root, mode=mode)
            return plan, time.perf_counter() - t0


# ---------------------------------------------------------------------------
# smoke: build once, serve a root-symmetric request stream warm
# ---------------------------------------------------------------------------

def run_smoke(n: int = 16, requests: int = 100,
              min_hit_rate: float = 0.9, verbose: bool = True) -> CacheStats:
    """Serve ``requests`` queries across every root of a vertex-transitive
    ring-``n`` (one orbit → exactly one build); assert the warm hit rate.
    This is the CI plan-service smoke."""
    from repro_torch.core import topology as T

    server = PlanServer()
    topo = T.ring(n)
    fp = server.register(topo)
    sizes = (64e3, 1e6, 4e6, 16e6)
    t0 = time.perf_counter()
    times = {}
    for i in range(requests):
        root = i % n
        nbytes = sizes[(i // n) % len(sizes)]
        t, _ = server.request(fp, root, nbytes)
        # vertex-transitive fabric: every root must answer identically
        ref = times.setdefault(nbytes, t)
        assert t == ref, (root, nbytes, t, ref)
    wall = time.perf_counter() - t0
    st = server.stats
    if verbose:
        print(f"plan-service smoke: ring-{n}, {requests} requests, "
              f"{st.builds} build(s), {st.relabels} relabel(s), "
              f"{st.l1_hits} L1 hits, hit rate {st.hit_rate:.3f}, "
              f"{wall:.2f}s wall")
    assert st.builds == 1, f"expected one orbit build, got {st.builds}"
    assert st.hit_rate >= min_hit_rate, \
        f"warm hit rate {st.hit_rate:.3f} < {min_hit_rate}"
    return st


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true",
                    help="build once, serve 100 root-symmetric requests, "
                         "assert >=90%% warm hits")
    ap.add_argument("--n", type=int, default=16, help="ring size")
    ap.add_argument("--requests", type=int, default=100)
    args = ap.parse_args(argv)
    if args.smoke:
        run_smoke(n=args.n, requests=args.requests)
        return 0
    ap.print_help()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
