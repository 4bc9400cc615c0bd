"""``tools/relay_cost.py``: the sets of moves it times on a butterfly's
plan, on the CPU at smoke size."""

import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import api
from repro_torch.core import topology as T
from repro_torch.core.simconfig import DeviceConfig, SimConfig
from repro_torch.device import round_step as rs
from repro_torch.device import runner

TOOL = Path(__file__).resolve().parents[1] / "tools" / "relay_cost.py"
CPU = SimConfig(device=DeviceConfig(device="cpu"))


@pytest.fixture(scope="module")
def tool():
    spec = importlib.util.spec_from_file_location("relay_cost", TOOL)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def plan():
    ex = api.compile(T.butterfly(16)).executable(0, 64e3, config=CPU)
    x = torch.zeros(16_000)
    lay = runner.packet_layout(x, ex.schedule, ex.num_groups)
    return lay, runner.build_moves(ex.schedule, ex.num_groups, x, "cpu")


def test_the_sets_drop_as_many_moves_a_subround(tool, plan):
    """``no_relay`` keeps no relay move and ``no_other`` every one, and
    drops as many other moves in each sub-round as it holds, up to its
    relay moves; the prefix sums are counted from the kept pairs."""
    lay, moves = plan
    sets = tool.variants(moves, lay.total, np.random.default_rng(3),
                         lay.row_bytes)
    full, no_relay, no_other = sets["all"], sets["no_relay"], sets["no_other"]
    assert full is moves and moves.relay_cum[-1] > 0
    assert no_relay.relay_cum[-1] == 0 and no_relay.relay_zeros_cum[-1] == 0
    assert no_other.relay_cum.tolist() == moves.relay_cum.tolist()
    assert no_other.relay_zeros_cum.tolist() == \
        moves.relay_zeros_cum.tolist()
    relay = np.diff(moves.relay_cum)
    assert (moves.counts - no_relay.counts).tolist() == relay.tolist()
    assert (moves.counts - no_other.counts).tolist() == \
        np.minimum(relay, moves.counts - relay).tolist()
    assert (no_other.counts == 0).sum() < (no_relay.counts == 0).sum()
    for m in (no_relay, no_other):
        assert m.num_subrounds == moves.num_subrounds
        assert m.offs.tolist() == m.moves_cum.tolist()
        assert m.offs[-1] == len(m.pairs)
        src = m.pairs[:, 1].numpy()
        assert m.zeros_cum[-1] == int((src < 0).sum())
        assert m.moved_bytes(0, m.num_subrounds, 8) == \
            int(2 * len(src) - (src < 0).sum()) * 8
    kept = {tuple(p) for p in no_relay.pairs.tolist()}
    assert kept <= {tuple(p) for p in moves.pairs.tolist()}


def test_a_set_runs_on_the_plain_path(tool, plan):
    """K1's plain path takes a set and counts its bytes."""
    lay, moves = plan
    m = tool.variants(moves, lay.total, np.random.default_rng(4),
                      lay.row_bytes)["no_other"]
    buf = torch.zeros(moves.n, moves.rows, lay.row_bytes, dtype=torch.uint8)
    before = (rs.moved_bytes, rs.relay_bytes)
    rs.permute_rounds(buf, m)
    assert (rs.moved_bytes - before[0], rs.relay_bytes - before[1]) == (
        m.moved_bytes(0, m.num_subrounds, lay.row_bytes),
        m.relay_bytes(0, m.num_subrounds, lay.row_bytes))


def test_main_prints_a_line_a_size(tool, capsys):
    assert tool.main(["--n", "16", "--sizes", "64e3,1e6", "--reps", "2",
                      "--device", "cpu"]) == 0
    lines = [json.loads(s) for s in capsys.readouterr().out.splitlines()]
    assert [d["nbytes"] for d in lines] == [64e3, 1e6]
    for d in lines:
        assert d["candidate"] == "two_tree" and d["relay_rows"] == 9
        assert d["moves"]["no_relay"] < d["moves"]["no_other"] < \
            d["moves"]["all"]
        assert d["bytes"]["all"] > d["bytes"]["no_relay"]
        assert set(d["us_median"]) == {"all", "no_relay", "no_other"}
        assert all(len(v) == 2 for v in d["us_all_reps"].values())
