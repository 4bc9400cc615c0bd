"""The whole request's share of the card's peak, %: the least bytes of the
window's broadcasts at the HBM peak over the window."""

from bcastbench import roofline


def read(rec):
    if not rec.done or rec.window_s <= 0:
        return None
    least = sum(roofline.least_bytes(rec.n, s.nbytes) for s in rec.done)
    return 100.0 * roofline.least_seconds(least) / rec.window_s
