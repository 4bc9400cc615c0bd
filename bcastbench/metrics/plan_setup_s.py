"""Seconds of set-up in the plan service: the plan store's load (and, on a
checkout's first run, its builds) and every root of the mix made warm in
the ``PlanServer`` (relabels), as the harness's spans time them."""


def read(rec):
    ph = rec.setup_phases
    if "plans" not in ph:
        return None
    return ph["plans"] + ph.get("relabels", 0.0)
