"""The 95th percentile latency of all the window's broadcasts, ms."""

from bcastbench.harness import percentile


def read(rec):
    p = percentile([s.seconds for s in rec.done], 95)
    return None if p is None else p * 1e3
