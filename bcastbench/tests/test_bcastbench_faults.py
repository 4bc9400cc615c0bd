"""Runs driven on the CPU past the look for a card, sound and with the
timed path broken underneath: ``correct`` has to come out false for each
fault a cell can have."""

import time

import pytest
import torch

from conftest import find

from bcastbench.drive import drive

SEED = 2 ** 31 + 4242


def _run(tiny, cell):
    return drive(find(tiny, cell), SEED, 1.0, False, time.perf_counter(),
                 device="cpu")


CELLS = ["mesh2d-16.large", "mesh2d-16.one_root"]


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(tiny, cell):
    result, checks = _run(tiny, cell)
    assert result["correct"], checks
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert checks["unchecked_shapes"] == [0, 0]
    assert set(result["metrics"]) == {"setup_s", "bcast_shape_p50_ms",
                                      "bcast_p95_ms", "payload_rate"}
    assert all(v["value"] > 0 for v in result["metrics"].values())


@pytest.mark.parametrize("seconds", [0.0, 0.5])
def test_the_window_ends_on_a_whole_block(tiny, seconds):
    cell = find(tiny, "mesh2d-16.large")
    result, _ = drive(cell, SEED, seconds, False, time.perf_counter(),
                      device="cpu")
    block = len(cell.mix["roots"]) * len(cell.mix["sizes"])
    assert result["attempted"] >= block
    assert result["attempted"] % block == 0


def test_a_traced_run_reads_its_per_layer_metrics(tiny):
    cell = find(tiny, "mesh2d-16.large")
    result, _ = drive(cell, SEED, 1.0, True, time.perf_counter(),
                      device="cpu")
    # no device trace on the CPU: only the host's readings come
    assert set(result["metrics"]) == {"plan_setup_s", "bcast_roofline.large",
                                      "requests_per_s.tiny"}


def _unchanged(orig):
    return lambda buf, tabs=None, moves=None: buf


def _half_left_out(orig):
    def unpack(buf, lay, x):
        out = orig(buf, lay, x)
        out[out.shape[0] // 2:] = 0
        return out
    return unpack


def _altered(orig):
    def unpack(buf, lay, x):
        out = orig(buf, lay, x)
        out.view(torch.uint8).view(-1)[7] ^= 0x10
        return out
    return unpack


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("name,fault", [
    ("run_cycles", _unchanged),        # a step that leaves its state as is
    ("unpack", _half_left_out),        # half of the nodes' copies left out
    ("unpack", _altered),              # an answer altered where it is made
])
def test_a_fault_is_not_correct(tiny, monkeypatch, cell, name, fault):
    from repro_torch.device import runner
    monkeypatch.setattr(runner, name, fault(getattr(runner, name)))
    result, checks = _run(tiny, cell)
    assert not result["correct"]
    assert checks["bad_bytes"][0] > checks["bad_bytes"][1]
