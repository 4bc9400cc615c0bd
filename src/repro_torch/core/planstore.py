"""Versioned, content-addressed store for BBS plan artifacts.

The paper's "build offline, store cheaply, reuse for any message size" (§2.6)
makes a plan a first-class artifact. This module gives those artifacts a real
format and lifecycle, replacing the ad-hoc name-keyed pickles the benchmark
harness used to drop under ``benchmarks/artifacts/plans/``:

  * **Key** — a plan is addressed by ``PlanKey``: the owning topology's
    content fingerprint (``repro_torch.core.routing.topology_fingerprint``: nodes,
    cables, Hockney constants, router attachment), the broadcast root, the
    conflict-model mode, and the engine ``SCHEMA_VERSION``. The key digest is
    the file name, so any drift — a re-wired fabric, a different root, new
    engine semantics — addresses a *different* artifact and can never silently
    reuse a stale one.
  * **Payload** — the pickled ``BBSPlan`` together with each candidate's
    compiled steady-state template (``Pipeline.flat_tasks()`` is materialized
    before storing), so a loaded plan replays through ``CompiledSim`` without
    re-deriving the template, plus build metadata (build seconds, creation
    time).
  * **Validation** — ``load`` re-derives the expected header from the key and
    raises ``StalePlanError`` on any mismatch (schema version, fingerprint,
    root, mode), including artifacts whose *content* disagrees with the name
    they were stored under. Unreadable or truncated files raise
    ``StalePlanError`` too, so callers can treat every failure mode as
    "rebuild".

Besides BBS plans, the store also caches *lowered baseline task lists*
(``BaselineKey`` / ``store_baseline`` / ``get_or_lower_baseline``): the
structural lowering of a routed baseline's ``SendTask`` list
(``repro_torch.core.routing.CompiledTaskList``, stripped of its process-local
dense resource ids) keyed by (fingerprint, mode, algorithm, root, nbytes),
so repeated baseline cells skip both task generation and lowering.

Bump ``SCHEMA_VERSION`` whenever the semantics or layout of pickled plans
change (SendTask/Pipeline/FlatTasks fields, simulator event ordering, probe
procedure, …). See ``docs/plan-artifacts.md`` for the on-disk format note.

This is the port's copy of ``repro.core.planstore`` (the JAX package's),
with one edit: every blob is read through ``_PortUnpickler``, which admits
only classes of ``repro_torch``, numpy, ``builtins`` and ``collections``.
The two packages write the same file names and layout, so a directory the
reference wrote can be opened here; its plan pickles name ``repro.core``
classes, and unpickling them would import the JAX package. Such a blob
raises ``StalePlanError`` (rebuild) instead. Calibration artifacts carry
only plain data and are read by both packages.
"""

from __future__ import annotations

import dataclasses
import hashlib
import inspect
import os
import pickle
import time
from typing import Callable, Optional, Sequence, Tuple

from repro_torch.core.intersection import FULL_DUPLEX
from repro_torch.core.routing import topology_fingerprint
from repro_torch.core.topology import Topology

# Engine schema version: the probe procedure, simulator semantics and the
# pickled plan layout this store was written against. Version history:
#   1 — the first ad-hoc pickles (implicit, unversioned)
#   2 — single-probe build_plan, compiled flat-task templates persisted,
#       picklable hierarchical routes, CompiledTopology routing layer
#   3 — round-batched engine: Candidate records the occupancy-cycle scan
#       hint (``repro_torch.core.fastsim.CycleInfo``), exact isolated group-0
#       probe replay, packed multi-root artifacts
#   4 — symmetry-orbit plan sharing: packed artifacts store one canonical
#       plan per vertex orbit plus permutation witnesses (non-canonical
#       roots relabel on load); ``Pipeline``/``FlatTasks``/``SendTask``/
#       ``CompiledTaskList`` grew route-override columns; the hierarchical
#       candidate rule became local-index-preserving (new fingerprints for
#       fat-tree/dragonfly fabrics)
#   5 — extended segment folds: ``SegmentInfo`` gained the ``pure`` field
#       and ``foldable`` now covers prefix/prev-segment lists (srda ring
#       allgather), so pickled ``CompiledTaskList.seg`` values from older
#       stores would misclassify under the new fold dispatch
SCHEMA_VERSION = 5

_MAGIC = "bbs-plan"
_MAGIC_PACKED = "bbs-plan-pack"
_MAGIC_BASELINE = "bbs-baseline-tasks"
_MAGIC_CALIBRATION = "bbs-calibration"


class StalePlanError(RuntimeError):
    """A plan artifact does not match the requesting key: wrong engine schema
    version, topology fingerprint, root or mode — or the file is unreadable.
    The artifact must be rebuilt, never deserialized against drifted code."""


# top-level packages a stored blob may name (``_PortUnpickler``)
_PICKLE_PACKAGES = ("repro_torch", "numpy", "builtins", "collections")


class _PortUnpickler(pickle.Unpickler):
    """Reads a blob that names only classes of ``_PICKLE_PACKAGES``; any
    other class (the reference's ``repro.core`` ones above all) raises
    ``StalePlanError`` before its module is imported."""

    def find_class(self, module, name):
        if module.split(".")[0] not in _PICKLE_PACKAGES:
            raise StalePlanError(
                f"the artifact names {module}.{name}, a class outside the "
                f"port (written by another package?); rebuild it")
        return super().find_class(module, name)


def _load_blob(path: str):
    with open(path, "rb") as f:
        return _PortUnpickler(f).load()


@dataclasses.dataclass(frozen=True)
class PackedPlanKey:
    """Content address of one *packed* multi-root plan artifact.

    One file per (topology fingerprint, mode, schema) holding every built
    root's plan. The paper's mean-over-all-roots tables at n=1024 mean ~1k
    per-root artifacts per fabric; packing collapses them into one file
    whose shared object graph (topology, conflict model, routing tables) is
    pickled once instead of per root.
    """

    fingerprint: str
    mode: str
    schema: int = SCHEMA_VERSION
    topo_name: str = ""       # informational only; not part of the digest

    @classmethod
    def for_topology(cls, topo: Topology,
                     mode: str = FULL_DUPLEX) -> "PackedPlanKey":
        return cls(fingerprint=topology_fingerprint(topo), mode=mode,
                   topo_name=topo.name)

    def digest(self) -> str:
        h = hashlib.sha256()
        h.update(repr((_MAGIC_PACKED, self.schema, self.fingerprint,
                       self.mode)).encode())
        return h.hexdigest()[:24]

    def filename(self) -> str:
        prefix = self.topo_name or "plan"
        return f"{prefix}-multiroot-{self.mode}-v{self.schema}" \
               f"-{self.digest()}.pkl"


@dataclasses.dataclass(frozen=True)
class BaselineKey:
    """Content address of one lowered baseline task-list artifact.

    Baseline schedules are deterministic in (topology, algorithm, root,
    message size), so their lowering (``repro_torch.core.routing.CompiledTaskList``
    minus the process-local dense resource ids) is as cacheable as a BBS
    plan. ``nbytes`` is part of the address because the task list itself
    depends on it (chain packet count, srda block sizes, Hockney durations).
    """

    fingerprint: str
    mode: str
    algo: str
    root: int
    nbytes: float
    schema: int = SCHEMA_VERSION
    topo_name: str = ""       # informational only; not part of the digest

    @classmethod
    def for_topology(cls, topo: Topology, algo: str, root: int,
                     nbytes: float, mode: str = FULL_DUPLEX) -> "BaselineKey":
        return cls(fingerprint=topology_fingerprint(topo), mode=mode,
                   algo=algo, root=root, nbytes=float(nbytes),
                   topo_name=topo.name)

    def digest(self) -> str:
        h = hashlib.sha256()
        h.update(repr((_MAGIC_BASELINE, self.schema, self.fingerprint,
                       self.mode, self.algo, self.root,
                       self.nbytes)).encode())
        return h.hexdigest()[:24]

    def filename(self) -> str:
        prefix = self.topo_name or "topo"
        return f"{prefix}-base-{self.algo}-r{self.root}-{self.mode}" \
               f"-v{self.schema}-{self.digest()}.pkl"


@dataclasses.dataclass(frozen=True)
class CalibrationKey:
    """Content address of one measured-cost artifact
    (``repro_torch.device.calibrate.CalibratedCost``).

    Calibration is a property of (fabric, execution environment), not of a
    root or message size: ``backend`` (jax platform) and ``num_devices``
    key the environment so an emulated-host fit is never mistaken for
    silicon numbers. The payload is the artifact's own versioned dict
    (``CalibratedCost.to_dict``), which external consumers
    (benchmarks/roofline.py) also read as plain JSON."""

    fingerprint: str
    backend: str
    num_devices: int
    schema: int = SCHEMA_VERSION
    topo_name: str = ""       # informational only; not part of the digest

    @classmethod
    def for_topology(cls, topo: Topology, backend: str,
                     num_devices: int) -> "CalibrationKey":
        return cls(fingerprint=topology_fingerprint(topo), backend=backend,
                   num_devices=int(num_devices), topo_name=topo.name)

    def digest(self) -> str:
        h = hashlib.sha256()
        h.update(repr((_MAGIC_CALIBRATION, self.schema, self.fingerprint,
                       self.backend, self.num_devices)).encode())
        return h.hexdigest()[:24]

    def filename(self) -> str:
        prefix = self.topo_name or "topo"
        return f"{prefix}-cal-{self.backend}{self.num_devices}" \
               f"-v{self.schema}-{self.digest()}.pkl"


@dataclasses.dataclass(frozen=True)
class PlanKey:
    """Content address of one plan artifact."""

    fingerprint: str          # topology_fingerprint(topo)
    root: int
    mode: str
    schema: int = SCHEMA_VERSION
    topo_name: str = ""       # informational only; not part of the digest

    @classmethod
    def for_topology(cls, topo: Topology, root: int = 0,
                     mode: str = FULL_DUPLEX) -> "PlanKey":
        return cls(fingerprint=topology_fingerprint(topo), root=root,
                   mode=mode, topo_name=topo.name)

    def digest(self) -> str:
        h = hashlib.sha256()
        h.update(repr((_MAGIC, self.schema, self.fingerprint,
                       self.root, self.mode)).encode())
        return h.hexdigest()[:24]

    def filename(self) -> str:
        """Human-readable prefix + content digest."""
        prefix = self.topo_name or "plan"
        return f"{prefix}-r{self.root}-{self.mode}-v{self.schema}" \
               f"-{self.digest()}.pkl"


class PlanStore:
    """Directory-backed artifact store for built broadcast plans.

    ``get_or_build`` is the one entry point the benchmark harness needs:
    in-memory memo -> on-disk artifact (validated) -> build and persist.
    """

    def __init__(self, root_dir: str):
        self.root_dir = root_dir
        self._memo: dict = {}

    # -- paths ---------------------------------------------------------------

    def path_for(self, key: PlanKey) -> str:
        return os.path.join(self.root_dir, key.filename())

    # -- load / store --------------------------------------------------------

    def load(self, key: PlanKey) -> Tuple[object, dict]:
        """Load and validate the artifact for ``key``.

        Returns (plan, meta). Raises ``FileNotFoundError`` when no artifact
        exists and ``StalePlanError`` when one exists but fails validation.
        """
        return self.load_path(self.path_for(key), key)

    @staticmethod
    def load_path(path: str, key: Optional[PlanKey] = None,
                  ) -> Tuple[object, dict]:
        """Load an artifact file, validating its header.

        Always checks the embedded schema version against the running
        ``SCHEMA_VERSION``; with ``key`` also checks fingerprint, root and
        mode. Raises ``StalePlanError`` with the exact mismatch."""
        if not os.path.exists(path):
            raise FileNotFoundError(path)
        try:
            blob = _load_blob(path)
        except Exception as exc:
            raise StalePlanError(
                f"plan artifact {path} is unreadable ({exc!r}); delete and "
                f"rebuild") from exc
        if not isinstance(blob, dict) or blob.get("magic") != _MAGIC:
            raise StalePlanError(
                f"{path} is not a PlanStore artifact (pre-PlanStore pickle?) "
                f"— rebuild it through PlanStore.store")
        header = blob["header"]
        if header["schema"] != SCHEMA_VERSION:
            raise StalePlanError(
                f"{path}: engine schema version {header['schema']} != "
                f"current {SCHEMA_VERSION}; plans must be rebuilt after "
                f"engine-schema changes")
        if key is not None:
            for field in ("fingerprint", "root", "mode"):
                want = getattr(key, field)
                got = header[field]
                if got != want:
                    raise StalePlanError(
                        f"{path}: {field} mismatch — artifact has {got!r}, "
                        f"requested topology/key has {want!r}; the stored "
                        f"plan belongs to a different fabric or build and "
                        f"must not be reused")
        return blob["plan"], dict(header, **blob.get("meta", {}))

    def store(self, key: PlanKey, plan, build_seconds: float = 0.0) -> str:
        """Persist ``plan`` under ``key``; returns the artifact path.

        Materializes every candidate's steady-state template
        (``Pipeline.flat_tasks()``) into the payload so a loaded plan
        replays through the batched engine without re-deriving it (the
        lowered ``CompiledTemplate`` is *not* persisted: it rebuilds in
        O(T) on first use, far below its on-disk numpy footprint — plans
        stay "cheap to store"). Write-temp-then-rename so a failed dump
        never leaves a partial artifact behind."""
        _materialize(plan)
        blob = {
            "magic": _MAGIC,
            "header": {
                "schema": key.schema,
                "fingerprint": key.fingerprint,
                "root": key.root,
                "mode": key.mode,
                "topo_name": key.topo_name,
            },
            "meta": {
                "build_seconds": build_seconds,
                "created": time.time(),
            },
            "plan": plan,
        }
        payload = pickle.dumps(blob)
        os.makedirs(self.root_dir, exist_ok=True)
        path = self.path_for(key)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(payload)
        os.replace(tmp, path)
        return path

    # -- the benchmark entry point -------------------------------------------

    def get_or_build(self, topo: Topology, root: int = 0,
                     mode: str = FULL_DUPLEX,
                     builder: Optional[Callable] = None,
                     ) -> Tuple[object, float, bool]:
        """Return (plan, build_seconds, was_cached) for (topo, root, mode).

        Checks the in-memory memo, then the on-disk artifact (validated
        against the key; stale artifacts are rebuilt and overwritten), and
        finally builds via ``builder`` (default ``repro_torch.core.bbs.build_plan``)
        and persists the result."""
        key = PlanKey.for_topology(topo, root=root, mode=mode)
        memo_key = key.digest()
        hit = self._memo.get(memo_key)
        if hit is not None:
            return hit[0], hit[1], True
        try:
            plan, meta = self.load(key)
            out = (plan, float(meta.get("build_seconds", 0.0)))
            self._memo[memo_key] = out
            return out[0], out[1], True
        except FileNotFoundError:
            pass
        except StalePlanError:
            # drifted artifact under the same name: rebuild and overwrite
            pass
        if builder is None:
            from repro_torch.core.bbs import build_plan
            builder = build_plan
        t0 = time.perf_counter()
        plan = builder(topo, root=root, mode=mode)
        build_seconds = time.perf_counter() - t0
        self.store(key, plan, build_seconds)
        self._memo[memo_key] = (plan, build_seconds)
        return plan, build_seconds, False

    # -- packed multi-root artifacts -----------------------------------------

    def path_for_packed(self, key: PackedPlanKey) -> str:
        return os.path.join(self.root_dir, key.filename())

    def store_packed(self, key: PackedPlanKey, plans: dict,
                     build_seconds: float = 0.0,
                     witnesses: Optional[dict] = None) -> str:
        """Persist ``plans`` (root -> BBSPlan) as one packed artifact.

        All plans must belong to the keyed fabric/mode; the shared object
        graph (topology, conflict model, templates) is pickled once for the
        whole file. With orbit sharing (``get_or_build_packed``) ``plans``
        holds only the canonical (orbit-representative) builds and
        ``witnesses`` maps every other served root to ``(canonical_root,
        permutation)`` — the automorphism that relabels the canonical plan
        onto that root, recorded at build time so loads replay the exact
        same relabeling."""
        for plan in plans.values():
            _materialize(plan)
        blob = {
            "magic": _MAGIC_PACKED,
            "header": {
                "schema": key.schema,
                "fingerprint": key.fingerprint,
                "mode": key.mode,
                "topo_name": key.topo_name,
                "roots": sorted(plans),
            },
            "meta": {
                "build_seconds": build_seconds,
                "created": time.time(),
            },
            "plans": dict(plans),
            "witnesses": dict(witnesses or {}),
        }
        payload = pickle.dumps(blob)
        os.makedirs(self.root_dir, exist_ok=True)
        path = self.path_for_packed(key)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(payload)
        os.replace(tmp, path)
        return path

    def load_packed(self, key: PackedPlanKey) -> Tuple[dict, dict]:
        """Load and validate the packed artifact for ``key``.

        Returns (plans-by-root, meta). Raises ``FileNotFoundError`` when no
        artifact exists and ``StalePlanError`` when one exists but fails
        validation (same rules as per-root artifacts)."""
        path = self.path_for_packed(key)
        if not os.path.exists(path):
            raise FileNotFoundError(path)
        try:
            blob = _load_blob(path)
        except Exception as exc:
            raise StalePlanError(
                f"packed plan artifact {path} is unreadable ({exc!r}); "
                f"delete and rebuild") from exc
        if not isinstance(blob, dict) or blob.get("magic") != _MAGIC_PACKED:
            raise StalePlanError(
                f"{path} is not a packed PlanStore artifact — rebuild it "
                f"through PlanStore.store_packed")
        header = blob["header"]
        if header["schema"] != SCHEMA_VERSION:
            raise StalePlanError(
                f"{path}: engine schema version {header['schema']} != "
                f"current {SCHEMA_VERSION}; plans must be rebuilt after "
                f"engine-schema changes")
        for field in ("fingerprint", "mode"):
            want = getattr(key, field)
            got = header[field]
            if got != want:
                raise StalePlanError(
                    f"{path}: {field} mismatch — artifact has {got!r}, "
                    f"requested topology/key has {want!r}; the stored plans "
                    f"belong to a different fabric or build and must not be "
                    f"reused")
        meta = dict(header, **blob.get("meta", {}))
        meta["witnesses"] = dict(blob.get("witnesses", {}))
        return blob["plans"], meta

    def get_or_build_packed(self, topo: Topology, roots: Sequence[int],
                            mode: str = FULL_DUPLEX,
                            builder: Optional[Callable] = None,
                            ) -> Tuple[dict, float, int]:
        """Return (plans-by-root for ``roots``, build_seconds, cached_count).

        Orbit-shared: each requested root is first canonicalized through
        the fabric's recorded automorphism group
        (``Topology.automorphisms()``). Only the missing *canonical* roots
        run the full ``builder`` (LP + probe + cycle scan, with one shared
        ``ConflictModel`` across all of them); every other root's plan is
        produced by relabeling its orbit representative through a
        permutation witness (``BBSPlan.relabel``), which replays
        bit-identically in the batched engine at O(tasks) cost. The packed
        artifact stores only the canonical plans plus the witnesses used,
        so a fabric with k orbits costs k builds no matter how many roots
        are served. ``cached_count`` counts requested roots served without
        invoking ``builder`` (loaded directly or relabeled from an
        already-present representative). Stale or unreadable artifacts are
        rebuilt in place like per-root ones."""
        key = PackedPlanKey.for_topology(topo, mode=mode)
        memo_key = key.digest()
        state = self._memo.get(memo_key)
        if state is None:
            try:
                plans, meta = self.load_packed(key)
                build_s = float(meta.get("build_seconds", 0.0))
                witnesses = {r: (c, tuple(p))
                             for r, (c, p) in meta["witnesses"].items()}
            except (FileNotFoundError, StalePlanError):
                plans, build_s, witnesses = {}, 0.0, {}
            # ``plans`` holds canonical builds (the only thing persisted);
            # ``derived`` memoizes relabeled plans per process so repeated
            # requests for the same non-canonical root relabel once
            state = {"plans": dict(plans), "build_s": build_s,
                     "witnesses": witnesses, "derived": {}}
            self._memo[memo_key] = state
        plans, witnesses = state["plans"], state["witnesses"]
        derived = state["derived"]

        aut = topo.automorphisms()
        cached = 0
        need_build = []
        for r in roots:
            if r in plans or r in derived:
                cached += 1
                continue
            if r not in witnesses:
                canon = aut.canonical_root(r)
                if canon != r:
                    witnesses[r] = (canon, aut.witness(r))
            canon = witnesses[r][0] if r in witnesses else r
            if canon in plans:
                cached += 1          # representative present: relabel only
            elif canon not in need_build:
                need_build.append(canon)

        if need_build:
            if builder is None:
                from repro_torch.core.bbs import build_plan
                builder = build_plan
            # build against the artifact's existing object graph (topology +
            # ConflictModel of an already-loaded plan) so incremental root
            # additions keep one shared graph in the pickle instead of
            # accreting a fresh copy per store cycle
            first = next(iter(plans.values()), None)
            if first is not None:
                topo_b, cm = first.topo, first.cm
            else:
                from repro_torch.core.intersection import ConflictModel
                topo_b, cm = topo, ConflictModel(topo, mode)
            takes_cm = False
            try:
                takes_cm = "cm" in inspect.signature(builder).parameters
            except (TypeError, ValueError):
                pass
            t0 = time.perf_counter()
            for r in need_build:
                if takes_cm:
                    plans[r] = builder(topo_b, root=r, mode=mode, cm=cm)
                else:
                    plans[r] = builder(topo_b, root=r, mode=mode)
            state["build_s"] += time.perf_counter() - t0
            self.store_packed(key, plans, state["build_s"], witnesses)

        for r in roots:
            if r not in plans and r not in derived:
                canon, perm = witnesses[r]
                derived[r] = plans[canon].relabel(perm)
        out = {r: plans.get(r, derived.get(r)) for r in roots}
        return out, state["build_s"], cached

    # -- maintenance ----------------------------------------------------------

    def prune(self) -> list:
        """Delete stale artifacts from the store directory; returns the
        removed paths.

        Removes leftover ``.pkl.tmp`` files from interrupted writes,
        unreadable pickles, files that are not PlanStore artifacts, artifacts
        from a different ``SCHEMA_VERSION``, and artifacts whose filename
        does not match the name recomputed from their own embedded header —
        renamed or drifted files address nothing and would otherwise rot in
        the directory forever. Only ``*.pkl`` / ``*.pkl.tmp`` files are
        considered; everything else in the directory is left alone."""
        removed = []
        if not os.path.isdir(self.root_dir):
            return removed
        for name in sorted(os.listdir(self.root_dir)):
            path = os.path.join(self.root_dir, name)
            if not os.path.isfile(path):
                continue
            if name.endswith(".pkl.tmp"):
                os.remove(path)
                removed.append(path)
                continue
            if not name.endswith(".pkl"):
                continue
            if self._expected_filename(path) != name:
                os.remove(path)
                removed.append(path)
        return removed

    @staticmethod
    def _expected_filename(path: str) -> Optional[str]:
        """Recompute the canonical filename from an artifact's own header;
        ``None`` when the file is unreadable, foreign, or wrong-schema."""
        try:
            blob = _load_blob(path)
        except Exception:
            return None
        if not isinstance(blob, dict):
            return None
        header = blob.get("header")
        if not isinstance(header, dict):
            return None
        try:
            if header["schema"] != SCHEMA_VERSION:
                return None
            magic = blob.get("magic")
            if magic == _MAGIC:
                key = PlanKey(fingerprint=header["fingerprint"],
                              root=header["root"], mode=header["mode"],
                              schema=header["schema"],
                              topo_name=header.get("topo_name", ""))
            elif magic == _MAGIC_PACKED:
                key = PackedPlanKey(fingerprint=header["fingerprint"],
                                    mode=header["mode"],
                                    schema=header["schema"],
                                    topo_name=header.get("topo_name", ""))
            elif magic == _MAGIC_BASELINE:
                key = BaselineKey(fingerprint=header["fingerprint"],
                                  mode=header["mode"], algo=header["algo"],
                                  root=header["root"],
                                  nbytes=header["nbytes"],
                                  schema=header["schema"],
                                  topo_name=header.get("topo_name", ""))
            elif magic == _MAGIC_CALIBRATION:
                key = CalibrationKey(fingerprint=header["fingerprint"],
                                     backend=header["backend"],
                                     num_devices=header["num_devices"],
                                     schema=header["schema"],
                                     topo_name=header.get("topo_name", ""))
            else:
                return None
        except KeyError:
            return None
        return key.filename()

    # -- lowered baseline task lists ------------------------------------------

    def path_for_baseline(self, key: BaselineKey) -> str:
        return os.path.join(self.root_dir, key.filename())

    def store_baseline(self, key: BaselineKey, lowered,
                       build_seconds: float = 0.0) -> str:
        """Persist a lowered baseline task list under ``key``.

        The pickle carries only the stable structural lowering — admission
        ranks, dependency fan-out, durations, segment detection; the dense
        resource ids are stripped by ``CompiledTaskList.__getstate__`` and
        rebind per process. Write-temp-then-rename like plan artifacts."""
        blob = {
            "magic": _MAGIC_BASELINE,
            "header": {
                "schema": key.schema,
                "fingerprint": key.fingerprint,
                "mode": key.mode,
                "algo": key.algo,
                "root": key.root,
                "nbytes": key.nbytes,
                "topo_name": key.topo_name,
            },
            "meta": {
                "build_seconds": build_seconds,
                "created": time.time(),
            },
            "tasks": lowered,
        }
        payload = pickle.dumps(blob)
        os.makedirs(self.root_dir, exist_ok=True)
        path = self.path_for_baseline(key)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(payload)
        os.replace(tmp, path)
        return path

    def load_baseline(self, key: BaselineKey):
        """Load and validate the lowered-baseline artifact for ``key``.

        Returns (CompiledTaskList, meta) — the list is *unbound* (no dense
        resource ids) until ``bind()``. Raises ``FileNotFoundError`` when no
        artifact exists and ``StalePlanError`` when one fails validation
        (same rules as plan artifacts)."""
        path = self.path_for_baseline(key)
        if not os.path.exists(path):
            raise FileNotFoundError(path)
        try:
            blob = _load_blob(path)
        except Exception as exc:
            raise StalePlanError(
                f"baseline artifact {path} is unreadable ({exc!r}); delete "
                f"and rebuild") from exc
        if not isinstance(blob, dict) or blob.get("magic") != _MAGIC_BASELINE:
            raise StalePlanError(
                f"{path} is not a baseline task-list artifact — rebuild it "
                f"through PlanStore.store_baseline")
        header = blob["header"]
        if header["schema"] != SCHEMA_VERSION:
            raise StalePlanError(
                f"{path}: engine schema version {header['schema']} != "
                f"current {SCHEMA_VERSION}; lowered baselines must be "
                f"rebuilt after engine-schema changes")
        for field in ("fingerprint", "mode", "algo", "root", "nbytes"):
            want = getattr(key, field)
            got = header[field]
            if got != want:
                raise StalePlanError(
                    f"{path}: {field} mismatch — artifact has {got!r}, "
                    f"requested key has {want!r}; the stored lowering "
                    f"belongs to a different fabric/algorithm/size and must "
                    f"not be reused")
        return blob["tasks"], dict(header, **blob.get("meta", {}))

    def get_or_lower_baseline(self, topo: Topology, cm, algo: str, root: int,
                              nbytes: float, lowered=None):
        """Return the lowered task list for ``(topo, cm.mode, algo, root,
        nbytes)``: in-memory memo -> on-disk artifact (validated; stale ones
        rebuilt in place) -> generate + lower (or take ``lowered``, a list
        the caller already built for this exact key) + persist.

        The returned object may already be bound to another model of the
        same fabric/mode, which is sound: every conflict resource is
        interned during the candidate-edge compile in
        ``CompiledTopology.__init__``, so equal-fingerprint models assign
        identical dense ids — the ``bind()`` after an artifact load exists
        for the stripped pickle, not for cross-model divergence."""
        # the compiled model caches the fabric fingerprint — don't re-hash
        # every candidate edge on every memo hit of the table grid
        key = BaselineKey(fingerprint=cm.compiled().fingerprint(),
                          mode=cm.mode, algo=algo, root=root,
                          nbytes=float(nbytes), topo_name=topo.name)
        memo_key = key.digest()
        hit = self._memo.get(memo_key)
        if hit is not None:
            return hit
        try:
            loaded, _ = self.load_baseline(key)
            self._memo[memo_key] = loaded
            return loaded
        except FileNotFoundError:
            pass
        except StalePlanError:
            pass   # drifted artifact under the same name: rebuild, overwrite
        t0 = time.perf_counter()
        if lowered is None:
            from repro_torch.core.baselines import BASELINES
            lowered = cm.compiled().lower_tasks(BASELINES[algo](topo, root,
                                                                nbytes))
        self.store_baseline(key, lowered, time.perf_counter() - t0)
        self._memo[memo_key] = lowered
        return lowered


    # -- measured-cost calibration artifacts -----------------------------------

    def path_for_calibration(self, key: CalibrationKey) -> str:
        return os.path.join(self.root_dir, key.filename())

    def store_calibration(self, key: CalibrationKey, cost) -> str:
        """Persist a ``repro_torch.device.calibrate.CalibratedCost`` under ``key``
        (payload is its versioned plain dict — no code objects, so the
        artifact outlives refactors of the dataclass)."""
        blob = {
            "magic": _MAGIC_CALIBRATION,
            "header": {
                "schema": key.schema,
                "fingerprint": key.fingerprint,
                "backend": key.backend,
                "num_devices": key.num_devices,
                "topo_name": key.topo_name,
            },
            "meta": {"created": time.time()},
            "cost": cost.to_dict(),
        }
        payload = pickle.dumps(blob)
        os.makedirs(self.root_dir, exist_ok=True)
        path = self.path_for_calibration(key)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(payload)
        os.replace(tmp, path)
        return path

    def load_calibration(self, key: CalibrationKey):
        """Load and validate the calibration artifact for ``key``; returns
        (CalibratedCost, meta). Same validation rules as plan artifacts."""
        from repro_torch.device.calibrate import CalibratedCost
        path = self.path_for_calibration(key)
        if not os.path.exists(path):
            raise FileNotFoundError(path)
        try:
            blob = _load_blob(path)
        except Exception as exc:
            raise StalePlanError(
                f"calibration artifact {path} is unreadable ({exc!r}); "
                f"delete and re-measure") from exc
        if not isinstance(blob, dict) or \
                blob.get("magic") != _MAGIC_CALIBRATION:
            raise StalePlanError(
                f"{path} is not a calibration artifact — rebuild it through "
                f"PlanStore.store_calibration")
        header = blob["header"]
        if header["schema"] != SCHEMA_VERSION:
            raise StalePlanError(
                f"{path}: engine schema version {header['schema']} != "
                f"current {SCHEMA_VERSION}; re-measure after engine-schema "
                f"changes")
        for field in ("fingerprint", "backend", "num_devices"):
            want = getattr(key, field)
            got = header[field]
            if got != want:
                raise StalePlanError(
                    f"{path}: {field} mismatch — artifact has {got!r}, "
                    f"requested key has {want!r}; the stored calibration "
                    f"belongs to a different fabric or environment")
        return CalibratedCost.from_dict(blob["cost"]), \
            dict(header, **blob.get("meta", {}))


def _materialize(plan) -> None:
    """Materialize every candidate's flat-task template before pickling; the
    lowered ``CompiledTemplate`` intentionally rebuilds lazily after load
    (O(T), cheaper than shipping its numpy arrays in every artifact)."""
    for cand in getattr(plan, "candidates", ()):
        cand.pipeline.flat_tasks()
        cand.pipeline.__dict__.pop("_compiled_template", None)
