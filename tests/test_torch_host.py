"""The port's copy of the numpy host layer gives the reference's plans and
device tables exactly: the same BBS candidates with bit-identical measured
ratios, the same selection at 4 KiB and 16 MiB, and for every candidate the
same ``DeviceSchedule`` field by field (or ``NotDeviceExecutable`` from
both)."""

import dataclasses

import numpy as np
import pytest

from repro.core import topology as RT
from repro.core.bbs import build_plan as ref_build_plan
from repro.core.intersection import ConflictModel as RefCM
from repro.device.schedule import NotDeviceExecutable as RefNDE
from repro.device.schedule import make_device_schedule as ref_mds
from repro_torch.core import topology as PT
from repro_torch.core.bbs import build_plan as port_build_plan
from repro_torch.core.intersection import ConflictModel as PortCM
from repro_torch.device.schedule import NotDeviceExecutable as PortNDE
from repro_torch.device.schedule import make_device_schedule as port_mds

FABRICS = {
    "ring8": lambda T: T.ring(8),
    "hypercube3": lambda T: T.hypercube(3),
    "mesh2d_3x3": lambda T: T.mesh2d(3, 3),
    "mesh2d_16x16": lambda T: T.mesh2d(16, 16),
}


def _schedule_or_error(mds, nde, pipe, n, compiled):
    try:
        return mds(pipe, n, compiled=compiled)
    except nde as e:
        return e


def assert_schedules_equal(ref, port):
    r, p = dataclasses.asdict(ref), dataclasses.asdict(port)
    assert r.keys() == p.keys()
    for k in r:
        if isinstance(r[k], np.ndarray):
            assert r[k].dtype == p[k].dtype, k
            np.testing.assert_array_equal(r[k], p[k], err_msg=k)
        else:
            assert r[k] == p[k], k


@pytest.mark.parametrize("fabric", list(FABRICS))
def test_plans_and_device_tables_match_reference(fabric):
    ref_topo, port_topo = FABRICS[fabric](RT), FABRICS[fabric](PT)
    ref_cm, port_cm = RefCM(ref_topo), PortCM(port_topo)
    ref = ref_build_plan(ref_topo, root=0, cm=ref_cm)
    port = port_build_plan(port_topo, root=0, cm=port_cm)

    assert [c.name for c in port.candidates] == \
        [c.name for c in ref.candidates]
    for rc, pc in zip(ref.candidates, port.candidates):
        assert (pc.a_hat, pc.b_hat) == (rc.a_hat, rc.b_hat), rc.name
    assert (port.L, port.B) == (ref.L, ref.B)
    for nbytes in (4 << 10, 16 << 20):
        top = len(ref.candidates)
        assert [(c.name, m) for c, m in port.select(nbytes, top=top)] == \
            [(c.name, m) for c, m in ref.select(nbytes, top=top)]

    n = ref_topo.num_nodes
    executable = 0
    for rc, pc in zip(ref.candidates, port.candidates):
        rs = _schedule_or_error(ref_mds, RefNDE, rc.pipeline, n,
                                ref_cm.compiled())
        ps = _schedule_or_error(port_mds, PortNDE, pc.pipeline, n,
                                port_cm.compiled())
        if isinstance(rs, Exception):
            assert isinstance(ps, PortNDE), (rc.name, rs)
            continue
        assert not isinstance(ps, Exception), (rc.name, ps)
        assert_schedules_equal(rs, ps)
        executable += 1
    assert executable > 0


@pytest.mark.parametrize("fabric", ["ring8", "hypercube3"])
def test_facade_predictions_match_reference(fabric):
    """``api.compile(topo)``'s simulator entry points agree with the
    reference's facade exactly."""
    from repro import api as ref_api
    from repro_torch import api as port_api

    ref = ref_api.compile(FABRICS[fabric](RT))
    port = port_api.compile(FABRICS[fabric](PT))
    for nbytes in (4 << 10, 16 << 20):
        t_ref, info_ref = ref.broadcast_time(root=3, nbytes=nbytes)
        t_port, info_port = port.broadcast_time(root=3, nbytes=nbytes)
        assert t_port == t_ref
        assert info_port == info_ref
        for algo in ("binomial", "bine_tree"):
            assert port.simulate_baseline(algo, 3, nbytes).finish_time == \
                ref.simulate_baseline(algo, 3, nbytes).finish_time
