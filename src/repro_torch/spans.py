"""Host spans of the broadcast path and its lowering.

``span(name)`` marks a stretch of host time as a ``with`` block. While
recording is off (the default) it returns one shared no-op object: no
allocation and no clock read. ``start()`` clears the record and turns
recording on; ``stop()`` turns it off and returns the closed spans in the
order they opened. Spans stay in memory until then; nothing is written
anywhere else.

A span holds its ``name``, ``t0`` and ``t1`` on ``time.perf_counter()``,
its own ``id``, its parent's (0 for none) and a request id. A span opened
with ``request=True`` outside every request opens a new request id, and
every span under it inherits it (0 outside requests). Parents come from a
stack kept per thread.

The spans the port opens, in layer order::

    bcast.run          ExecutablePlan.run on one card        (request=True)
      lower.place      runner.place, a shape's first run: K1's row offsets
      runner.pack      runner.broadcast around LoweredPlan.start
      runner.cycles    runner.broadcast around K1 (LoweredPlan.cycles)
      runner.unpack    runner.broadcast around LoweredPlan.finish (on a
                       GPU: at most one unpack_rows launch)
    lower.executable   build_executable
      lower.schedule   each make_device_schedule inside it
    lower.moves        runner.build_moves / build_tables
      lower.slot_tables, lower.compact_moves, lower.phases (a GPU's),
      lower.upload

``Timeline`` answers which span holds a time, and ``attribute`` sums
device seconds by the innermost span that holds each one's launch: how a
profiler trace of the device is split by the program's spans.
"""

from __future__ import annotations

import bisect
import itertools
import threading
import time
from typing import Dict, Iterable, List, NamedTuple, Optional, Tuple


class Span(NamedTuple):
    name: str
    t0: float
    t1: float
    id: int
    parent: int
    request: int

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0


class _Off:
    """What ``span`` returns while recording is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()
_on = False
_record: List[tuple] = []              # Span fields, made Spans at stop()
_ids = itertools.count(1)
_requests = itertools.count(1)
_local = threading.local()


def _stack() -> list:
    st = getattr(_local, "stack", None)
    if st is None:
        st = _local.stack = []
    return st


class _Open:
    __slots__ = ("name", "request_root", "id", "parent", "request", "t0")

    def __init__(self, name: str, request_root: bool):
        self.name = name
        self.request_root = request_root

    def __enter__(self):
        st = _stack()
        up = st[-1] if st else None
        self.id = next(_ids)
        self.parent = up.id if up else 0
        self.request = up.request if up else 0
        if self.request_root and not self.request:
            self.request = next(_requests)
        st.append(self)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        st = _stack()
        if st and st[-1] is self:
            st.pop()
        if _on:
            _record.append((self.name, self.t0, t1, self.id, self.parent,
                            self.request))
        return False


def span(name: str, request: bool = False):
    """A ``with`` block recorded as span ``name`` while recording is on;
    ``request=True`` makes it open a request id when it is in none."""
    if not _on:
        return _OFF
    return _Open(name, request)


def start() -> None:
    """Clear the record and turn recording on."""
    global _on
    _record.clear()
    _on = True


def stop() -> List[Span]:
    """Turn recording off; the spans closed since ``start()``, by id (the
    order they opened)."""
    global _on
    _on = False
    out = sorted(map(Span._make, _record), key=lambda s: s.id)
    _record.clear()
    return out


class Timeline:
    """The innermost of a set of nested spans at each time: ``at(t)``, and
    the seconds of an interval under each (``overlap``). Spans of one
    thread nest; a span that closes out of turn is taken off wherever it
    lies on the stack."""

    def __init__(self, spans: Iterable[Span]):
        marks = []
        for s in spans:
            if s.t1 <= s.t0:
                continue
            marks.append((s.t0, 1, s.id, s))
            marks.append((s.t1, 0, -s.id, s))       # closes before opens
        marks.sort(key=lambda m: m[:3])
        self.cuts: List[float] = []
        self.held: List[Optional[Span]] = []
        stack: List[Span] = []
        for t, opening, _, s in marks:
            if opening:
                stack.append(s)
            else:
                for i in range(len(stack) - 1, -1, -1):
                    if stack[i] is s:
                        del stack[i]
                        break
            top = stack[-1] if stack else None
            if self.cuts and self.cuts[-1] == t:
                self.held[-1] = top
            else:
                self.cuts.append(t)
                self.held.append(top)

    def at(self, t: float) -> Optional[Span]:
        """The innermost span with ``t0 <= t < t1``, or None."""
        i = bisect.bisect_right(self.cuts, t) - 1
        return self.held[i] if i >= 0 else None

    def overlap(self, a: float, b: float) -> List[Tuple[Optional[Span],
                                                        float]]:
        """The seconds of ``[a, b)`` under each innermost span (None: no
        span), in time order."""
        out: List[Tuple[Optional[Span], float]] = []
        i = bisect.bisect_right(self.cuts, a) - 1
        t = a
        while t < b:
            end = min(self.cuts[i + 1], b) if i + 1 < len(self.cuts) else b
            if end > t:
                out.append((self.held[i] if i >= 0 else None, end - t))
            t = end
            i += 1
        return out


def attribute(timeline: Timeline,
              launches: Iterable[Tuple[Optional[float], float]]
              ) -> Tuple[Dict[int, float], float]:
    """Device seconds by the span that launched them: ``launches`` gives,
    for each device operation, the host time of the call that launched it
    (None when unknown) and its device seconds. Returns seconds by the id
    of the innermost span that holds the launch, and the seconds that no
    span claims (no launch time, or a launch outside every span)."""
    by: Dict[int, float] = {}
    none = 0.0
    for t, sec in launches:
        s = None if t is None else timeline.at(t)
        if s is None:
            none += sec
        else:
            by[s.id] = by.get(s.id, 0.0) + sec
    return by, none
