"""The device's side of a traced window, from ``torch.profiler``.

Only device activity is recorded (kernels, copies, fills): the host's side
is the harness's own spans, which cost nothing to keep. A marker fill,
launched alone on an idle card at a known host time, is the first device
event of the trace and ties the device's clock to the host's, so each idle
gap can be named by what the host was doing then.
"""

from __future__ import annotations

import bisect
import dataclasses
import time
from typing import Callable, Dict, List, Optional, Tuple

import torch

Event = Tuple[str, float, float]          # name, start, seconds (host clock)


@dataclasses.dataclass
class DeviceTrace:
    """Device events of one traced window, on the host's ``perf_counter``
    clock: ``events`` after the marker, the window ``[start, end]``, and
    the seconds in which some device operation ran (``busy_s``)."""

    events: List[Event]
    start: float
    end: float
    busy_s: float

    @property
    def window_s(self) -> float:
        return self.end - self.start

    def seconds(self, match: Callable[[str], bool],
                spans: Optional[List[Tuple[float, float]]] = None) -> float:
        """Device seconds of the events whose name ``match``es; with
        ``spans`` (sorted, on the host clock), only of those that start
        inside one of them."""
        starts = [a for a, _ in spans] if spans else None

        def inside(t: float) -> bool:
            i = bisect.bisect_right(starts, t) - 1
            return i >= 0 and t <= spans[i][1]
        return sum(d for name, t, d in self.events
                   if match(name) and (spans is None or inside(t)))

    def by_name(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for name, _, d in self.events:
            out[name] = out.get(name, 0.0) + d
        return out

    def gaps(self) -> List[Tuple[float, float]]:
        """The idle stretches of the window: no device operation ran."""
        out, t = [], self.start
        for s, e in _merged(self.events, self.start, self.end):
            if s > t:
                out.append((t, s))
            t = max(t, e)
        if self.end > t:
            out.append((t, self.end))
        return out


def _merged(events: List[Event], lo: float, hi: float
            ) -> List[Tuple[float, float]]:
    spans = sorted((max(lo, s), min(hi, s + d)) for _, s, d in events)
    out: List[Tuple[float, float]] = []
    for s, e in spans:
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


class Tracer:
    """Records the device's side of a window: ``start()`` before it (the
    card idle), ``stop(end)`` after, ``end`` on the host clock."""

    def __init__(self, device: torch.device):
        self.device = device
        self.prof = None
        self.mark = 0.0

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile
        marker = torch.zeros(1, device=self.device)
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.__enter__()
        torch.cuda.synchronize(self.device)
        self.mark = time.perf_counter()
        marker.fill_(1.0)
        torch.cuda.synchronize(self.device)

    def stop(self, end: float) -> Optional[DeviceTrace]:
        torch.cuda.synchronize(self.device)
        self.prof.__exit__(None, None, None)
        raw = device_events(self.prof)
        self.prof = None
        if not raw:
            return None
        raw.sort(key=lambda e: e[1])
        shift = raw[0][1] - self.mark          # the marker fill comes first
        events = [(name, s - shift, d) for name, s, d in raw[1:]]
        busy = sum(e - s for s, e in _merged(events, self.mark, end))
        return DeviceTrace(events=events, start=self.mark, end=end,
                           busy_s=busy)


def device_events(prof) -> List[Event]:
    """``(name, start s, seconds)`` of every device event the profiler
    kept, on the profiler's clock."""
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != torch.autograd.DeviceType.CUDA:
            continue
        out.append((e.name(), e.start_ns() * 1e-9, e.duration_ns() * 1e-9))
    return out


def short_name(name: str, width: int = 120) -> str:
    """A kernel's name without its return type, cut to ``width`` letters
    (enough to tell PyTorch's elementwise kernels apart by their functor)."""
    name = name[5:] if name.startswith("void ") else name
    return name if len(name) <= width else name[:width - 3] + "..."


def breakdown(tr: DeviceTrace, label: Callable[[float], str]) -> dict:
    """The ``breakdown`` of a result line: the ten device operations that
    took most time, and the idle time of the window summed by what the host
    was doing (``label`` of a gap's midpoint), the ten largest."""
    ops = sorted(tr.by_name().items(), key=lambda kv: -kv[1])[:10]
    ops = [(short_name(k), v) for k, v in ops]
    idle: Dict[str, float] = {}
    for s, e in tr.gaps():
        k = label(0.5 * (s + e))
        idle[k] = idle.get(k, 0.0) + (e - s)
    gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[k, v] for k, v in ops],
            "idle_gaps": [[k, v] for k, v in gaps]}
