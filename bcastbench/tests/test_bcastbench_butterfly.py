"""The ``butterfly-256.large`` cell: found by name with its configuration
and mix, its fabric planned on the CPU as the two-tree plan with relay rows
that the cell runs, and the six per-layer metrics of the ``.large`` cells
read in it under their own names."""

import dataclasses

import pytest

from bcastbench import manifest, virtual
from bcastbench.devtrace import DeviceTrace
from bcastbench.harness import RunRecord, Served
from conftest import ROOT

CELL = "butterfly-256.large"
# the per-layer metrics every ``.large`` cell reports, this one too
READERS = ["k1_us_per_subround.large", "k1_roofline.large",
           "runner_dev_ms.large", "plan_setup_s", "bcast_roofline.large",
           "device_idle_pct.large"]


@pytest.fixture(scope="module")
def cell():
    return manifest.find_cell(CELL, root=ROOT)


def test_the_cell_is_found_with_its_config_and_mix(cell):
    assert cell.chips == 1 and cell.workload["traffic"] == "large"
    assert cell.config["name"] == "butterfly-256"
    assert cell.config["build"] == {"fn": "butterfly", "args": [256],
                                    "kwargs": {"preset": "edr"}}
    assert cell.config["reduced"] == {}
    assert cell.mix["roots"] == [0, 17]
    assert cell.mix["sizes"] == [4000000, 16000000, 64000000, 128000000]
    assert sorted(m["name"] for m in cell.per_layer) == sorted(READERS)
    assert cell.per_layer == manifest.find_cell(
        "mesh2d-256.large", root=ROOT).per_layer
    assert {m["name"] for m in cell.end_to_end} == {
        "setup_s", "bcast_shape_p50_ms", "bcast_p95_ms", "payload_rate"}


def test_the_fabric_plans_two_trees_with_relay_rows(cell):
    """Root 0's plan at 4e6 B, as the cell lowers it on the card, is the
    two-tree candidate: 904 sub-rounds, 8 a cycle, 2 packets a cycle and
    33 relay slots."""
    from repro_torch import api
    from repro_torch.core.simconfig import DeviceConfig, SimConfig

    topo = virtual.build_topology(cell.config)
    assert topo.num_nodes == 256
    ex = api.compile(topo).executable(0, 4e6, config=SimConfig(
        device=DeviceConfig(device="cpu")))
    assert ex.candidate == "two_tree"
    assert (ex.schedule.d, ex.schedule.K, ex.schedule.num_relay,
            ex.num_subrounds) == (8, 2, 33, 904)


def _record():
    """Two requests and a traced window: K1, a fill and a copy inside the
    requests, a copy between them."""
    served = [Served(root=0, nbytes=4_000_000, t0=1.0, t1=1.01,
                     subrounds=904),
              Served(root=17, nbytes=16_000_000, t0=1.02, t1=1.05,
                     subrounds=1752)]
    events = [("fill", 1.0001, 0.0004), ("permute_rounds_kernel", 1.0006,
                                         0.006),
              ("unpack_rows", 1.007, 0.002), ("copy", 1.015, 0.003),
              ("fill", 1.0201, 0.0013), ("permute_rounds_kernel", 1.022,
                                         0.012),
              ("unpack_rows", 1.035, 0.009)]
    trace = DeviceTrace(events=events, start=1.0, end=1.05, busy_s=0.0349)
    return RunRecord(cell=CELL, n=256, setup_s=9.0,
                     setup_phases={"plans": 0.78, "relabels": 0.01},
                     served=served, window_s=0.05,
                     k1={"launches": 2, "subrounds": 2656}, trace=trace)


@pytest.mark.parametrize("name", READERS)
def test_the_large_readers_read_in_the_cell(cell, name):
    """Each reads the butterfly's record, and nothing where it finds
    nothing to read: no set-up phases, trace or window."""
    rec = _record()
    got = cell.reader(name).read(rec)
    assert got is not None and got > 0
    bare = dataclasses.replace(rec, setup_phases={}, k1={}, trace=None,
                               window_s=0.0)
    assert cell.reader(name).read(bare) is None
