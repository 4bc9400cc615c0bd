"""``BENCHMARK.json`` against the benchmark's contract, and the files it
names found by name."""

import json
import re

import pytest

from conftest import ROOT, TINY_CELLS, find

MAN = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRICS = MAN["end_to_end"] + MAN["per_layer"]
CELLS = {w["name"]: w for w in MAN["workloads"]}


def test_keys_and_command():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert MAN["command"] == ["python3", "bcastbench/run.py"]
    assert MAN["paths"] == ["bcastbench"]
    assert 1 <= MAN["run_seconds"] <= 51


@pytest.mark.parametrize("name", [c["name"] for c in MAN["configs"]] +
                         list(CELLS) + [m["name"] for m in METRICS] +
                         [w["traffic"] for w in CELLS.values()])
def test_names(name):
    assert NAME.match(name), name


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_metric(metric):
    assert UNIT.match(metric["unit"]) and len(metric["unit"]) <= 16
    assert metric["better"] in ("lower", "higher")
    assert metric["source"] in ("device_trace", "program_span",
                                "program_counter", "host_clock")
    assert (ROOT / "bcastbench" / "metrics" /
            f"{metric['name']}.py").is_file()
    for cell in metric.get("workloads", ()):
        assert cell in CELLS


@pytest.mark.parametrize("metric", MAN["end_to_end"], ids=lambda m: m["name"])
def test_end_to_end_bounds(metric):
    assert set(metric) <= {"name", "unit", "better", "bound", "source",
                           "workloads"}
    assert metric["source"] in ("host_clock", "device_trace")
    assert 0.01 <= metric["bound"] <= 0.25
    if metric["name"] == "setup_s":
        assert metric["bound"] <= 0.25


def _reports(cell: str):
    return {m["name"] for m in MAN["end_to_end"]
            if "workloads" not in m or cell in m["workloads"]}


@pytest.mark.parametrize("metric", MAN["per_layer"], ids=lambda m: m["name"])
def test_each_moves_names_an_end_to_end_metric_its_cells_report(metric):
    assert set(metric) == {"name", "unit", "better", "source", "layer",
                           "moves", "workloads"}
    assert metric["moves"] in {m["name"] for m in MAN["end_to_end"]}
    for cell in metric["workloads"]:
        assert metric["moves"] in _reports(cell)


@pytest.mark.parametrize("cell", list(CELLS))
def test_every_cell_reports_setup_and_another_metric(cell):
    assert "setup_s" in _reports(cell) and len(_reports(cell)) >= 2
    assert any(cell in m["workloads"] for m in MAN["per_layer"])
    w = CELLS[cell]
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
    assert (ROOT / "bcastbench" / "mixes" / f"{w['traffic']}.json").is_file()


def test_pairs_are_unique_and_four_chip_cells_few():
    pairs = [(w["config"], w["traffic"]) for w in CELLS.values()]
    assert len(pairs) == len(set(pairs))
    four = sum(w["chips"] == 4 for w in CELLS.values())
    assert four <= max(1, len(CELLS) // 4)


def test_layers_are_named_alike():
    perf = (ROOT / "PERF.md").read_text()
    for layer in {m["layer"] for m in MAN["per_layer"]}:
        assert f"**{layer}**" in perf, layer


@pytest.mark.parametrize("conf", MAN["configs"], ids=lambda c: c["name"])
def test_config_files(conf):
    assert set(conf) == {"name", "source", "file", "reduced", "why"}
    assert conf["file"].startswith("bcastbench/configs/")
    data = json.loads((ROOT / conf["file"]).read_text())
    assert data["name"] == conf["name"] and data["source"] == conf["source"]
    assert sorted(data["reduced"]) == sorted(conf["reduced"])
    assert len(conf["reduced"]) <= 16
    assert any(w["config"] == conf["name"] for w in CELLS.values())


def test_a_full_check_fits_its_time():
    per_run = MAN["run_seconds"] + 60
    assert (2 + 14 * 24) * per_run + 24 * 2 * 90 + 1200 <= 43200


def test_the_file_is_small():
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("cell", list(TINY_CELLS))
def test_cells_added_as_files_are_found_by_name(tiny, cell):
    c = find(tiny, cell)
    assert c.config["name"] == TINY_CELLS[cell][0]
    assert c.mix is not None and c.generator().stream
    assert "requests_per_s.tiny" in [m["name"] for m in c.per_layer]
    assert c.reader("requests_per_s.tiny").read


def test_an_unknown_cell_raises(tiny):
    with pytest.raises(KeyError):
        find(tiny, "no-such.cell")
