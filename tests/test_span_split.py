"""``tools/span_split.py``'s join of a profiler window to the port's spans,
on made-up device and runtime events: the tie to the marker's launch, a
device operation matched by either id, one whose launch is missing, one
launched outside every span, and the idle time split by the span it falls
in."""

import importlib.util
from pathlib import Path

import pytest
import torch

from repro_torch import spans

TOOL = Path(__file__).resolve().parents[1] / "tools" / "span_split.py"


@pytest.fixture(scope="module")
def tool():
    spec = importlib.util.spec_from_file_location("span_split", TOOL)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Ev:
    def __init__(self, name, start, dur=0, corr=0, linked=0, dev=False):
        self._v = (name, start, dur, corr, linked, dev)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2]

    def correlation_id(self):
        return self._v[3]

    def linked_correlation_id(self):
        return self._v[4]

    def device_type(self):
        cuda = torch.autograd.DeviceType
        return cuda.CUDA if self._v[5] else cuda.CPU


MARK = 100.0
US = 1_000


def _events(drift=0):
    """A traced window on the profiler's clock: the marker (launched at
    950 µs) and the tracer's synchronize, one request's fill, K1 and copy,
    an operation whose runtime call is missing, the request's synchronize
    of its stream, and a copy launched after it; from the request's
    synchronize on, the profiler's clock runs ``drift`` µs behind."""
    d = drift * US
    return [
        Ev("fill_marker", 1_000 * US, 2 * US, corr=1, dev=True),
        Ev("cudaLaunchKernel", 950 * US, 5 * US, corr=1),
        Ev("cudaDeviceSynchronize", 960 * US, 45 * US, corr=9),
        Ev("fill", 1_300 * US, 400 * US, corr=2, dev=True),
        Ev("cudaLaunchKernel", 1_100 * US, 5 * US, corr=2),
        Ev("cuLaunchKernel", 1_102 * US, 2 * US, corr=2),    # inside it
        Ev("permute_rounds_kernel", 1_700 * US, 1_000 * US, corr=0,
           linked=3, dev=True),
        Ev("cudaLaunchCooperativeKernel", 1_200 * US, 5 * US, corr=3),
        Ev("copy", 2_700 * US, 2_000 * US, corr=4, dev=True),
        Ev("cudaLaunchKernel", 1_300 * US, 5 * US, corr=4),
        Ev("lost", 4_800 * US, 100 * US, corr=77, dev=True),
        Ev("cudaStreamSynchronize", 1_400 * US - d, 3_590 * US, corr=6),
        Ev("Memcpy DtoD", 6_000 * US - d, 50 * US, corr=5, dev=True),
        Ev("cudaMemcpyAsync", 5_990 * US - d, 5 * US, corr=5),
        Ev("aten::fill_", 1_000 * US, 5 * US),
    ]


def _t(us):
    """The host time of a profiler time in µs, tied at the marker's launch
    (950 µs)."""
    return MARK + (us - 950) * 1e-6


# the request: called at 1,050 µs, ``run`` returned at 1,395 µs, the
# synchronize (1,400-4,990 µs) returned and was read at 4,995 µs
SERVED = [{"root": 0, "nbytes": 64, "t0": _t(1_050), "t_ret": _t(1_395),
           "t1": _t(4_995)}]


def test_launches_are_joined_by_either_id(tool):
    got = tool.launches_of(_events())
    assert got["matched"] == {"correlation_id": 4,
                              "linked_correlation_id": 1, "none": 1}
    assert got["calls"]["cudaLaunchKernel"] == 3
    assert got["syncs"] == [(1_400 * US, 4_990 * US)]     # the request's
    ops = {name: (s, d, launch) for name, s, d, launch in got["ops"]}
    assert got["ops"][0][0] == "fill_marker"
    assert ops["fill"] == (1_300 * US, 400 * US, 1_100 * US)
    assert ops["permute_rounds_kernel"][2] == 1_200 * US
    assert ops["lost"][2] is None


@pytest.mark.parametrize("drift", [0, 300])
def test_times_are_tied_at_the_marker_and_each_synchronize(tool, drift):
    """The marker's launch is tied to the mark; a drift of the profiler's
    clock is taken up at the request's synchronize, tied halfway between
    what the harness's two reads around it allow (5 µs before and 5 µs
    after the call here)."""
    got = tool.on_host(tool.launches_of(_events(drift)), MARK, SERVED)
    assert got["marker_tie_us"] == pytest.approx(50.0)
    assert got["anchors"] == 2
    assert got["tie_drift_us"] == pytest.approx(drift)
    ops = {name: (t, d, launch) for name, t, d, launch in got["ops"]}
    assert "fill_marker" not in ops and len(ops) == 5
    assert ops["fill"] == (pytest.approx(_t(1_300)), pytest.approx(4e-4),
                           pytest.approx(_t(1_100)))
    assert ops["Memcpy DtoD"][0] == pytest.approx(_t(6_000))
    assert ops["Memcpy DtoD"][2] == pytest.approx(_t(5_990))


def test_a_stalled_read_moves_no_tie(tool):
    """Of three requests, the middle one's read after its synchronize comes
    400 µs late (the host stalled): the bounds of its neighbours keep the
    tie where they put it, halfway between 10 µs before and 2 µs after."""
    evs = [Ev("fill_marker", 1_000 * US, 2 * US, corr=1, dev=True),
           Ev("cudaLaunchKernel", 950 * US, 5 * US, corr=1),
           Ev("cudaDeviceSynchronize", 960 * US, 45 * US, corr=9)]
    served = []
    for k in range(3):
        base = 2_000 * (k + 1)
        evs += [Ev("cudaStreamSynchronize", (base + 500) * US, 500 * US,
                   corr=20 + k),
                Ev(f"op{k}", (base + 100) * US, 300 * US, corr=30 + k,
                   dev=True),
                Ev("cudaLaunchKernel", (base + 50) * US, 5 * US,
                   corr=30 + k)]
        late = 400 if k == 1 else 0
        served.append({"t0": _t(base), "t_ret": _t(base + 490),
                       "t1": _t(base + 1_002 + late)})
    got = tool.on_host(tool.launches_of(evs), MARK, served)
    assert got["anchors"] == 4
    ops = {name: launch for name, _, _, launch in got["ops"]}
    assert ops["op2"] == pytest.approx(_t(6_046))
    assert got["tie_drift_us"] == pytest.approx(-4.0)


def test_bounds_that_do_not_meet_take_the_median_middle(tool):
    """The profiler's clock falls 100 µs behind after the first of three
    requests: their bounds have no common offset, and each tie takes the
    median of the requests' own middles."""
    evs = [Ev("fill_marker", 1_000 * US, 2 * US, corr=1, dev=True),
           Ev("cudaLaunchKernel", 950 * US, 5 * US, corr=1),
           Ev("cudaDeviceSynchronize", 960 * US, 45 * US, corr=9)]
    served = []
    for k in range(3):
        base, lag = 2_000 * (k + 1), 100 * (k > 0)
        evs += [Ev("cudaStreamSynchronize", (base + 500 - lag) * US,
                   500 * US, corr=20 + k),
                Ev("cudaLaunchKernel", (base + 50 - lag) * US, 5 * US,
                   corr=30 + k),
                Ev(f"op{k}", (base + 100 - lag) * US, 300 * US, corr=30 + k,
                   dev=True)]
        served.append({"t0": _t(base), "t_ret": _t(base + 490),
                       "t1": _t(base + 1_002)})
    got = tool.on_host(tool.launches_of(evs), MARK, served)
    ops = {name: launch for name, _, _, launch in got["ops"]}
    assert ops["op2"] == pytest.approx(_t(6_046))
    assert got["tie_drift_us"] == pytest.approx(96.0)


def test_without_a_marker_launch_the_device_start_is_tied(tool):
    evs = [e for e in _events() if not (e.correlation_id() == 1 and
                                        not e._v[5])]
    got = tool.on_host(tool.launches_of(evs), MARK, SERVED)
    assert got["marker_tie_us"] is None and got["anchors"] == 1
    ops = {name: launch for name, _, _, launch in got["ops"]}
    assert ops["fill"] == pytest.approx(MARK + 100e-6)


def test_split_by_the_spans_that_launched(tool):
    got = tool.on_host(tool.launches_of(_events()), MARK, SERVED)
    run = spans.Span("bcast.run", _t(1_060), _t(1_350), 1, 0, 1)
    window = [run,
              spans.Span("runner.pack", _t(1_080), _t(1_150), 2, 1, 1),
              spans.Span("runner.cycles", _t(1_150), _t(1_250), 3, 1, 1),
              spans.Span("runner.unpack", _t(1_250), _t(1_340), 4, 1, 1)]
    out = tool.split(got["ops"], window, SERVED, MARK, _t(6_100))
    assert out["requests"] == 1
    assert out["dev_ms"]["runner.pack"] == pytest.approx(0.4)
    assert out["dev_ms"]["runner.cycles"] == pytest.approx(1.0)
    assert out["dev_ms"]["runner.unpack"] == pytest.approx(2.0)
    assert out["dev_ms"]["bcast.run"] == 0 and out["dev_ms"]["run"] == 0
    # the operation with no launch and the copy launched between requests
    assert out["unclaimed_s"] == pytest.approx(150e-6)
    assert out["unclaimed_in_requests_s"] == pytest.approx(100e-6)
    assert out["busy_in_requests_s"] == pytest.approx(3.5e-3)
    assert out["k1_named_s"] == pytest.approx(1e-3)
    assert out["runner_named_ms"] == pytest.approx(2.5)
    assert out["per_shape_dev_ms"] == {"0/64": pytest.approx(
        {"runner.pack": 0.4, "runner.cycles": 1.0, "runner.unpack": 2.0})}
    idle = out["idle_by_span_s"]
    # before the fill: the harness, the request's call, bcast.run, pack,
    # cycles and unpack (the host ahead of the card); after the copy the
    # synchronize ("run") and, once the request is over, the harness
    assert idle == pytest.approx({
        "harness": 1155e-6, "run": 205e-6, "bcast.run": 20e-6,
        "runner.pack": 70e-6, "runner.cycles": 100e-6,
        "runner.unpack": 50e-6})
    assert out["run_idle_us"] == pytest.approx(240.0)
    assert sum(out["idle_by_midpoint_s"].values()) == pytest.approx(
        sum(idle.values()))


def test_split_refuses_a_window_whose_runs_do_not_match(tool):
    with pytest.raises(RuntimeError):
        tool.split([], [], [{"root": 0, "nbytes": 1, "t0": 0.0, "t1": 1.0}],
                   0.0, 1.0)


def test_unpack_share_of_the_hbm_peak_by_shape(tool):
    """``unpack_hbm_pct``: the staged copy's 2 x n x nbytes at 3.35 TB/s
    over the unpack's device ms a request, by shape; a shape with no unpack
    time is left out."""
    per_shape = {"0/128000000": {"runner.pack": 10.0, "runner.cycles": 30.0,
                                 "runner.unpack": 25.0},
                 "17/4000000": {"runner.pack": 0.3, "runner.cycles": 2.0,
                                "runner.unpack": 0.0}}
    moved = {"0/128000000": 2 * 256 * 128e6, "17/4000000": 2 * 256 * 4e6}
    got = tool.unpack_hbm_pct(per_shape, moved)
    assert got == {"0/128000000": pytest.approx(
        100 * 2 * 256 * 128e6 / 3.35e12 / 25e-3)}
    assert 78 < got["0/128000000"] < 79


def test_unpack_share_on_the_bytes_unpack_rows_moved(tool):
    """In place, ``unpack_rows`` copies only the tails: ``unpack_by_shape``
    averages each request's growth of ``runner.unpack_bytes`` by shape, and
    ``unpack_hbm_pct`` divides those bytes at the peak by the unpack's
    device ms; a shape that moved none (no straddling row) is left out."""
    served = [{"root": 0, "nbytes": 128, "unpack": 2_000_000},
              {"root": 0, "nbytes": 128, "unpack": 4_000_000},
              {"root": 17, "nbytes": 64, "unpack": 0}]
    moved = tool.unpack_by_shape(served)
    assert moved == {"0/128": 3_000_000, "17/64": 0}
    per_shape = {"0/128": {"runner.unpack": 0.002},
                 "17/64": {"runner.unpack": 0.001}}
    got = tool.unpack_hbm_pct(per_shape, moved)
    assert got == {"0/128": pytest.approx(100 * 3e6 / 3.35e12 / 2e-6)}


def test_relay_share_by_shape(tool):
    """``relay_pct``: the relay bytes over K1's moved bytes of each shape's
    requests, from each request's growth of the two counters; a shape whose
    requests moved nothing is left out."""
    served = [{"root": 0, "nbytes": 4, "moved": 100, "relay": 12},
              {"root": 0, "nbytes": 4, "moved": 300, "relay": 28},
              {"root": 17, "nbytes": 4, "moved": 50, "relay": 0},
              {"root": 0, "nbytes": 8, "moved": 0, "relay": 0}]
    assert tool.relay_pct(served) == {"0/4": pytest.approx(10.0),
                                      "17/4": 0.0}


def test_phase_share_by_shape(tool):
    """``phase_pct``: K1's steps over its sub-rounds, by shape and over
    all, from each request's growth of ``round_step.phases`` and
    ``round_step.subrounds``; a shape that ran no sub-round is left out."""
    served = [{"root": 0, "nbytes": 4, "subrounds": 1368, "phases": 170},
              {"root": 0, "nbytes": 4, "subrounds": 1368, "phases": 170},
              {"root": 17, "nbytes": 4, "subrounds": 705, "phases": 705},
              {"root": 0, "nbytes": 8, "subrounds": 0, "phases": 0}]
    assert tool.phase_pct(served) == {
        "0/4": pytest.approx(100 * 170 / 1368), "17/4": 100.0,
        "all": pytest.approx(100 * 1045 / 3441)}
