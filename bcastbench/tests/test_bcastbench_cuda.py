"""On a card: a run of a small cell through the CLI's own path, the same
runs with faults planted in the in-place path that every request takes
there, and the control. They skip without one."""

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


def _counted_no_op(buf, moves, s0, s1, at, stream):
    """K1's launch that moves nothing but is counted as a launch of its
    sub-rounds, so that only the comparison of the answers can see it."""
    from repro_torch.device import round_step
    round_step.rounds_launches += 1
    round_step.subrounds += s1 - s0


def _no_op(*args):
    pass


# the names ``runner.run_inplace`` calls that each fault replaces
IN_PLACE_FAULTS = {
    # K1 skipped: the output holds the root's payload and a zeroed scratch
    # beside what the block held before
    "k1_skipped": {"launch_rounds": _counted_no_op},
    # the block handed back as it stood: no fill, no K1, no tail copy, so
    # it holds an earlier answer of the same size
    "block_as_it_stood": {"_launch_fill": _no_op,
                          "launch_rounds": _counted_no_op,
                          "_launch_tail": _no_op},
}


def _plant_after_warmup(monkeypatch, fakes):
    """Replace ``runner``'s names in ``fakes`` by stand-ins that call the
    real ones until the harness makes its ``Keeper``, which it does once
    the warm-up is done, and the fakes from then on. Returns the count of
    faulted calls, in ``hits``."""
    from bcastbench import harness
    from repro_torch.device import runner

    state = {"armed": False, "hits": 0}

    class Armed(harness.Keeper):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            state["armed"] = True

    def stand_in(real, fake):
        def call(*args):
            if not state["armed"]:
                return real(*args)
            state["hits"] += 1
            return fake(*args)
        return call

    monkeypatch.setattr(harness, "Keeper", Armed)
    for name, fake in fakes.items():
        monkeypatch.setattr(runner, name, stand_in(getattr(runner, name),
                                                   fake))
    return state


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["mesh2d-16.large", "mesh2d-16.one_root"])
@pytest.mark.parametrize("fault", list(IN_PLACE_FAULTS))
def test_an_in_place_fault_is_not_correct(cuda_card, tiny, monkeypatch, cell,
                                          fault):
    from repro_torch.device import runner

    state = _plant_after_warmup(monkeypatch, IN_PLACE_FAULTS[fault])
    inplace, staged = runner.inplace_runs, runner.staged_runs
    result, checks = drive(find(tiny, cell), 2 ** 31 + 77, 1.0, False,
                           time.perf_counter())
    # every request, warm-up and check ones too, took the in-place path,
    # and the fault acted in the window's
    assert runner.staged_runs == staged
    assert runner.inplace_runs - inplace >= result["attempted"]
    assert state["hits"] >= result["attempted"]
    # K1's counters agree with the plans: only the answers show the fault
    assert checks["k1_subround_gap"] == [0, 0]
    assert checks["k1_launch_gap"] == [0, 0]
    assert not result["correct"]
    assert checks["bad_bytes"][0] > checks["bad_bytes"][1]
