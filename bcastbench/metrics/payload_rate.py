"""Payload bytes of every completed broadcast over the whole window, GB/s
(the window runs from its start to the end of its last request)."""


def read(rec):
    if not rec.done or rec.window_s <= 0:
        return None
    return sum(s.nbytes for s in rec.done) / rec.window_s / 1e9
