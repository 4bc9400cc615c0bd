"""Unified simulation configuration (``SimConfig``) and the legacy-kwarg shim.

The simulation entrypoints (``simulate_pipeline`` / ``simulate_baseline`` /
``broadcast_time`` / ``build_plan``) accreted per-call knobs one PR at a
time — ``engine=``, ``faults=``, the cycle-detection options — until every
caller hand-threaded the same half-dozen keywords. ``SimConfig`` is the one
object that carries them; entrypoints accept ``config=SimConfig(...)`` and
the old keywords keep working through :func:`resolve_config`:

  * legacy kwargs default to the ``UNSET`` sentinel, so "not passed" and
    "passed the old default" are distinguishable;
  * passing both ``config=`` and a legacy kwarg is a ``TypeError`` (silently
    preferring one would hide bugs);
  * the first legacy use in a process emits a single ``DeprecationWarning``
    through one shared warning path (``_warn_legacy``); the resolved config
    is otherwise bit-identical to the old behavior — the same values land in
    the same engine code, asserted in tests/test_api.py.

Kept free of imports from the simulator/engine modules so everything above
it (simulator, baselines, bbs, fastsim) can depend on it without cycles.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import TYPE_CHECKING, Optional

if TYPE_CHECKING:   # simulator/fastsim import this module; type-only here
    from repro_torch.core.fastsim import CycleInfo
    from repro_torch.core.faults import FaultSchedule

# the engine identifier every entrypoint defaults to (re-exported by
# repro.core.simulator for backward compatibility)
DEFAULT_ENGINE = "fast"


class _Unset:
    """Sentinel distinguishing "kwarg not passed" from any real value."""

    __slots__ = ()

    def __repr__(self) -> str:   # keep reprs in error messages readable
        return "<UNSET>"

    def __bool__(self) -> bool:
        return False


UNSET = _Unset()


@dataclasses.dataclass(frozen=True)
class DeviceConfig:
    """Device-execution options (the ``SimConfig.device`` block).

    ``device`` is the torch device the virtual mesh runs on: ``"cuda"`` (the
    default; the packet buffers of all n virtual devices live on one GPU and
    every sub-round is one launch of the hand-written round-step kernel) or
    ``"cpu"`` (the plain PyTorch round step, for tests). Asking for
    ``"cuda"`` on a host without a GPU raises when the executable is built;
    it never falls back to the CPU. ``dtype`` is the payload dtype the runner
    is built for. Validated eagerly like every other config block: a bad
    value raises here, not inside a run."""

    device: str = "cuda"
    dtype: str = "float32"

    _DTYPES = ("float32", "float16", "bfloat16", "int32", "uint32", "int8",
               "uint8")
    _DEVICES = ("cuda", "cpu")

    def __post_init__(self):
        if self.dtype not in self._DTYPES:
            raise ValueError(
                f"DeviceConfig.dtype {self.dtype!r} not in {self._DTYPES}")
        if self.device not in self._DEVICES:
            raise ValueError(
                f"DeviceConfig.device {self.device!r} not in {self._DEVICES}")


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """Simulation options shared by every ``simulate_*`` entrypoint.

    ``engine`` selects the execution engine: ``"fast"`` — the flat-array
    engine, the default everywhere; ``"kernel"`` — the event core over the
    lowered arrays (``repro_torch.core.kernelsim``: a hand-written CUDA
    kernel on the device of the ``device`` block, cuda by default; falls
    back to the numpy path for faults, pipelines and foldable lists);
    ``"reference"`` — the oracle.
    ``faults`` is an optional ``repro.core.faults.FaultSchedule``; a
    non-empty schedule routes the run through the engine's fault loop.
    ``cycle_detect`` / ``cycle_scan_groups`` / ``cycle_hint`` control the
    verified occupancy-cycle analytics of the fast engine;
    ``max_sim_groups`` bounds the simulated pipeline prefix (Theorem-2
    extrapolation beyond it) and ``max_sim_segments`` is its task-list
    analogue (``simulate_baseline``). ``device`` is the device-execution
    block (``DeviceConfig``) consumed by ``repro.api`` ``executable()`` /
    ``repro.device`` and by the kernel engine, which runs its event core
    there; it does not affect simulation results. Frozen: derive
    variants with ``dataclasses.replace``.
    """

    engine: str = DEFAULT_ENGINE
    faults: Optional["FaultSchedule"] = None
    cycle_detect: bool = True
    cycle_scan_groups: Optional[int] = None
    cycle_hint: Optional["CycleInfo"] = None
    max_sim_groups: int = 6
    max_sim_segments: Optional[int] = None
    device: Optional[DeviceConfig] = None

    def __post_init__(self):
        if self.device is not None and not isinstance(self.device,
                                                      DeviceConfig):
            raise TypeError(
                f"SimConfig.device must be a DeviceConfig, "
                f"got {type(self.device).__name__}")


_legacy_warned = False


def _warn_legacy(names) -> None:
    """The single deprecation warning path for every legacy sim kwarg.

    Warns once per process (the old call forms are pervasive in tests and
    downstream scripts; a warning per call would drown real ones) —
    ``reset_legacy_warning`` re-arms it for tests."""
    global _legacy_warned
    if _legacy_warned:
        return
    _legacy_warned = True
    warnings.warn(
        f"legacy simulation keyword(s) {', '.join(names)} are deprecated; "
        f"pass config=repro.core.simconfig.SimConfig(...) instead "
        f"(this warning is emitted once per process)",
        DeprecationWarning, stacklevel=4)


def reset_legacy_warning() -> None:
    """Re-arm the once-per-process legacy warning (test helper)."""
    global _legacy_warned
    _legacy_warned = False


def resolve_config(config: Optional[SimConfig], **legacy) -> SimConfig:
    """Merge a ``config=`` argument with legacy per-call kwargs.

    ``legacy`` values equal to ``UNSET`` were not passed and are ignored.
    With ``config`` given, any explicitly-passed legacy kwarg raises (the
    call is ambiguous); with no ``config``, explicit legacy kwargs override
    the ``SimConfig`` defaults after the one-time deprecation warning. The
    resolved values are exactly what the pre-``SimConfig`` signatures used,
    so old and new call forms produce bit-identical results."""
    given = {k: v for k, v in legacy.items() if v is not UNSET}
    if config is not None:
        if given:
            raise TypeError(
                f"pass either config= or the legacy keyword(s) "
                f"{sorted(given)}, not both")
        return config
    if not given:
        return SimConfig()
    _warn_legacy(sorted(given))
    return SimConfig(**given)
