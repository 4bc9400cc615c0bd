"""K1's device microseconds a sub-round: ``permute_rounds``' device time in
the window over the sub-rounds it ran (``round_step.subrounds``)."""


def read(rec):
    tr = rec.trace
    subrounds = rec.k1.get("subrounds", 0)
    if tr is None or subrounds <= 0:
        return None
    k1 = tr.seconds(lambda name: "permute_rounds" in name)
    return k1 / subrounds * 1e6 if k1 > 0 else None
