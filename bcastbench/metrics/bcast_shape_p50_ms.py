"""The median of the mix's shape medians, ms: for each (root, size) the
median latency of the window's completed requests of that shape, call to
synchronize, then the median of those. Each shape median is the median of
many requests, so no single request moves it far; with the mix's 8 shapes
it is the mean of the 4th and 5th shape medians."""

from bcastbench.harness import percentile


def read(rec):
    by_shape = {}
    for s in rec.done:
        by_shape.setdefault((s.root, s.nbytes), []).append(s.seconds)
    p = percentile([percentile(v, 50) for v in by_shape.values()], 50)
    return None if p is None else p * 1e3
