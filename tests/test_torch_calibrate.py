"""The port's calibration (``repro_torch.device.calibrate``) against the
reference's (``repro.device.calibrate``): the Hockney fit, the cycle-time
prediction and the calibrated fabric's fingerprint are exactly equal; the
``CalibratedCost`` JSON artifact reads across the packages both ways; the
ring rounds ``measure_round`` times deliver on the CPU; ``calibrate`` and
``prediction_report`` give the reference's meta keys and row fields. The
timings here are CPU times of the plain round step, held to no bound."""

import dataclasses
import importlib
import math

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from repro import api as ref_api
from repro.core import topology as RT
from repro.core.routing import topology_fingerprint as ref_fingerprint
from repro_torch import api as port_api
from repro_torch.core import topology as PT
from repro_torch.core.routing import topology_fingerprint as port_fingerprint
from repro_torch.core.simconfig import DeviceConfig, SimConfig
from repro_torch.device import round_step as rs

# the packages export a function ``calibrate`` beside the module
RC = importlib.import_module("repro.device.calibrate")
PC = importlib.import_module("repro_torch.device.calibrate")
CPU = SimConfig(device=DeviceConfig(device="cpu"))
FABRICS = {
    "ring8": lambda T: T.ring(8),
    "hypercube3": lambda T: T.hypercube(3),
    "mesh2d_3x3": lambda T: T.mesh2d(3, 3),
}
SIZES = [1 << 10, 8 << 10, 64 << 10, 256 << 10, 1 << 20]


@pytest.mark.parametrize("times", [
    [2e-5 + s / 40e9 for s in SIZES],                 # exact line
    [3.1e-6, 3.4e-6, 5.2e-6, 1.1e-5, 3.3e-5],         # a measured shape
    [5e-6, 4e-6, 4.5e-6, 4.2e-6, 4.1e-6],             # negative slope
    [9e-6, 1e-6, 1.2e-5, 2.5e-5, 8.1e-5],             # negative intercept
])
def test_fit_hockney_equals_reference(times):
    assert PC._fit_hockney(SIZES, times) == RC._fit_hockney(SIZES, times)
    assert PC._fit_hockney(SIZES[:2], times[:2]) == \
        RC._fit_hockney(SIZES[:2], times[:2])


@pytest.mark.parametrize("fabric", list(FABRICS))
def test_predict_cycle_time_equals_reference(fabric):
    ref = ref_api.compile(FABRICS[fabric](RT))
    port = port_api.compile(FABRICS[fabric](PT))
    cost = {"tpu_ici": (1.25e-6, 3.5e11), "host": (7e-6, 2e10)}
    for root, nbytes in ((0, 4 << 10), (3, 1 << 20), (1, 4 << 20)):
        rex = ref.executable(root=root, nbytes=nbytes)
        pex = port.executable(root=root, nbytes=nbytes, config=CPU)
        assert (pex.candidate, pex.num_groups) == \
            (rex.candidate, rex.num_groups)
        for cls in (None, "host"):
            assert PC.predict_cycle_time(pex, PC.CalibratedCost(cost), cls) \
                == RC.predict_cycle_time(rex, RC.CalibratedCost(cost), cls)


@pytest.mark.parametrize("fabric", list(FABRICS))
def test_apply_calibration_equals_reference(fabric):
    cost = {"tpu_ici": (1e-5, 5e10)}
    rt = RC.apply_calibration(FABRICS[fabric](RT), RC.CalibratedCost(cost))
    pt = PC.apply_calibration(FABRICS[fabric](PT), PC.CalibratedCost(cost))
    assert port_fingerprint(pt) == ref_fingerprint(rt)
    assert port_fingerprint(pt) != port_fingerprint(FABRICS[fabric](PT))
    assert pt.name == rt.name and pt.latency((0, 1)) == rt.latency((0, 1))
    with pytest.raises(ValueError):
        PC.apply_calibration(PT.fat_tree(32, radix=8),
                             PC.CalibratedCost(cost))


def test_calibrated_cost_json_reads_across_packages(tmp_path):
    meta = {"backend": "cuda", "emulated": True, "sizes": [1024, 8192],
            "round_seconds": [3.2e-6, 3.9e-6], "device_name": "card"}
    classes = {"tpu_ici": (1.5e-5, 45e9), "host": (2e-6, 1.25e11)}
    port = PC.CalibratedCost(classes=dict(classes), meta=dict(meta))
    ref = RC.CalibratedCost.load(port.save(str(tmp_path / "port.json")))
    assert (ref.classes, ref.meta) == (port.classes, port.meta)
    back = PC.CalibratedCost.load(ref.save(str(tmp_path / "ref.json")))
    assert (back.classes, back.meta) == (classes, meta)
    assert port.to_dict() == ref.to_dict()
    assert back.round_time("host", 1.25e11) == 1.0 + 2e-6
    with pytest.raises(ValueError):
        PC.CalibratedCost.from_dict({"magic": "something-else"})


@pytest.mark.parametrize("n,nbytes", [(8, 1 << 10), (5, 4099), (1, 64),
                                      (16, 3)])
def test_ring_rounds_deliver_on_cpu(n, nbytes):
    """Row 1 of every device ends equal to row 0 of its predecessor, after
    the plain round step runs ``iters`` ring sub-rounds; the row is the
    float32 row rounded up to 16 bytes."""
    buf, moves = PC.ring_round(n, nbytes, "cpu", iters=3)
    row = PC.ring_row_bytes(nbytes)
    assert tuple(buf.shape) == (n, 2, row) and row % 16 == 0
    assert row >= max(4, nbytes // 4 * 4) > row - 16
    assert moves.num_subrounds == 3 and list(moves.counts) == [n] * 3
    assert not PC.ring_delivered(buf)
    rs.permute_rounds(buf, moves)
    assert PC.ring_delivered(buf)
    want = torch.roll(buf[:, 0], 1, dims=0)
    assert torch.equal(buf[:, 1], want)
    buf[n - 1, 1, 0] ^= 1                  # one flipped bit is not delivery
    assert not PC.ring_delivered(buf)


def test_measure_round_on_cpu():
    t = PC.measure_round(8, 8 << 10, device="cpu", iters=4, reps=2)
    assert math.isfinite(t) and t > 0


def test_measure_round_raises_without_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        PC.measure_round(8, 1 << 10, device="cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        PC.calibrate(PT.ring(8), sizes=(1 << 10, 8 << 10))
    with pytest.raises(ValueError):
        PC.measure_round(8, 1 << 10, device="meta")


def test_calibrate_and_report_on_cpu_have_reference_fields():
    mesh = Mesh(np.array(jax.devices()[:1]), ("dev",))
    ref = RC.calibrate(RT.ring(8), mesh, sizes=(1 << 10, 8 << 10), iters=2,
                       reps=1)
    model = port_api.compile(PT.ring(8))
    ex = model.executable(root=0, nbytes=64 << 10, config=CPU)
    sizes = (1 << 10, 8 << 10, 64 << 10)
    cost = ex.calibrate(sizes=sizes, iters=4, reps=2)
    assert set(ref.meta) <= set(cost.meta)
    assert list(cost.classes) == list(ref.classes) == ["tpu_ici"]
    a, b = cost.classes["tpu_ici"]
    assert a >= 0 and b > 0 and math.isfinite(a) and math.isfinite(b)
    assert cost.meta["backend"] == "cpu" and cost.meta["emulated"] is True
    assert cost.meta["num_devices"] == 8 and cost.meta["sizes"] == \
        list(sizes)
    assert cost.meta["row_bytes"] == [PC.ring_row_bytes(s) for s in sizes]
    assert all(t > 0 for t in cost.meta["round_seconds"])
    assert PC.calibrate(None, 4, device="cpu", sizes=sizes, iters=2,
                        reps=1).classes.keys() == {"host"}

    rows = PC.prediction_report([ex], cost, reps=2)
    assert [f.name for f in dataclasses.fields(rows[0])] == \
        [f.name for f in dataclasses.fields(RC.PredictionRow)]
    row = rows[0]
    assert (row.topo, row.candidate, row.nbytes) == \
        ("ring_8", ex.candidate, 64 << 10)
    assert row.num_cycles == ex.schedule.num_cycles(ex.num_groups)
    assert row.predicted_cycle_s == PC.predict_cycle_time(ex, cost)
    assert row.measured_cycle_s > 0 and math.isfinite(row.rel_err)
