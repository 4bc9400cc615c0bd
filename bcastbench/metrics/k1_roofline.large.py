"""K1's share of its roofline, %: the least bytes of the window's
broadcasts (``roofline.least_bytes``) at the HBM peak, over
``permute_rounds``' device time in the window."""

from bcastbench import roofline


def read(rec):
    tr = rec.trace
    if tr is None:
        return None
    k1 = tr.seconds(lambda name: "permute_rounds" in name)
    if k1 <= 0:
        return None
    least = sum(roofline.least_bytes(rec.n, s.nbytes) for s in rec.done)
    return 100.0 * roofline.least_seconds(least) / k1
