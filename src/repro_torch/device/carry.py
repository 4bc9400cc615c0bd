"""State carried across from the reference: device schedules.

A reference ``repro.device.schedule.DeviceSchedule`` given as plain data --
``dataclasses.asdict`` of it, or that dict through JSON (tuples become
lists, arrays become nested lists) -- becomes the port's
``DeviceSchedule``, so tables the JAX package compiled run unchanged on
the port's virtual mesh. It is this system's counterpart of loading a
model's weights into the port; the LM's weights themselves are carried by
``repro_torch.models.carry.import_lm_params``. The port's own invariant (no
device sends and receives one row in one sub-round) is checked on the way
in.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np

from repro_torch.device.schedule import (DeviceSchedule,
                                         _check_no_send_recv_overlap)

_TABLES = ("send_rel", "recv_rel", "send_abs", "recv_abs")


def import_schedule(fields: Mapping) -> DeviceSchedule:
    """The port's ``DeviceSchedule`` from a reference schedule's fields."""
    n, d = int(fields["num_devices"]), int(fields["d"])
    perms = [[(int(a), int(b)) for a, b in pairs] for pairs in fields["perms"]]
    if len(perms) != d:
        raise ValueError(f"{len(perms)} matchings for d={d} sub-rounds")
    tables = {}
    for name in _TABLES:
        t = np.asarray(fields[name], dtype=np.int64)
        if t.shape != (d, n):
            raise ValueError(f"{name} has shape {t.shape}, expected {(d, n)}")
        tables[name] = t.copy()
    _check_no_send_recv_overlap(*(tables[k] for k in _TABLES))
    return DeviceSchedule(num_devices=n, K=int(fields["K"]), d=d,
                          max_arrival=int(fields["max_arrival"]),
                          perms=perms, num_relay=int(fields["num_relay"]),
                          root=int(fields["root"]), **tables)
