"""On a card: a run of a small cell through the CLI's own path, and the
control there. They skip without one."""

import time

import pytest
import torch

from conftest import find

from bcastbench.control import control_bad_bytes
from bcastbench.drive import drive


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["mesh2d-16.large", "mesh2d-16.one_root"])
@pytest.mark.parametrize("trace", [False, True])
def test_a_small_cell_on_the_card(cuda_card, tiny, cell, trace):
    result, checks = drive(find(tiny, cell), 2 ** 31 + 99, 1.0, trace,
                           time.perf_counter())
    assert result["correct"], checks
    assert checks["k1_subround_gap"] == [0, 0]
    assert result["device"]["platform"] == "gpu"
    if trace:
        assert 0 < result["device"]["busy_s"] <= result["device"]["window_s"]
        assert result["breakdown"]["device_ops"]


@pytest.mark.cuda
def test_the_control_fails_on_the_card(cuda_card, tiny):
    row = control_bad_bytes(find(tiny, "mesh2d-16.large"), 5,
                            torch.device("cuda"))
    assert row["bad_bytes"] > 1000
