"""The median latency of the window's broadcasts, call to synchronize, ms."""

from bcastbench.harness import percentile


def read(rec):
    p = percentile([s.seconds for s in rec.done], 50)
    return None if p is None else p * 1e3
