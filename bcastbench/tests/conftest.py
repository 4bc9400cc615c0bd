"""Fixtures of the benchmark's own tests (``python -m pytest
bcastbench/tests`` from the repository's root; the repository's test run
does not collect them).

``tiny`` is a copy of the benchmark in a temporary checkout with small
cells added as new files (a 4 x 4 mesh under two mixes), their
configuration, mixes and one new metric, found by name like every other;
the tests drive runs of them on the CPU."""

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

# each tiny cell, its configuration, mix and cards, and the cell of
# BENCHMARK.json whose per-layer metrics it reports too
TINY_CELLS = {
    "mesh2d-16.large": ("mesh2d-16", "tiny_large", 1, "mesh2d-256.large"),
    "mesh2d-16.one_root": ("mesh2d-16", "tiny_one_root", 1,
                           "mesh2d-256.large"),
}


@pytest.fixture
def cuda_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False)")


def _json(path: Path, obj) -> None:
    path.write_text(json.dumps(obj, indent=1) + "\n")


def make_tiny(dest: Path) -> Path:
    """A checkout at ``dest``: ``BENCHMARK.json`` and a copy of
    ``bcastbench/`` with the tiny cells' files added."""
    base = dest / "bcastbench"
    shutil.copytree(ROOT / "bcastbench", base, ignore=shutil.ignore_patterns(
        ".cache", "__pycache__", "tests"))
    man = json.loads((ROOT / "BENCHMARK.json").read_text())
    mesh = json.loads((base / "configs" / "mesh2d-256.json").read_text())
    mesh.update(name="mesh2d-16", nodes=16, rows=4, cols=4,
                build={"fn": "mesh2d", "args": [4, 4],
                       "kwargs": {"preset": "ndr400"}})
    _json(base / "configs" / "mesh2d-16.json", mesh)
    for name, upd in (
            ("tiny_large", {"roots": [0, 5], "sizes": [4096, 64000],
                            "keep_bytes": 2 * 16 * 4096}),
            ("tiny_one_root", {"roots": [3], "sizes": [4096, 16384],
                               "keep_bytes": 0})):
        mix = json.loads((base / "mixes" / "large.json").read_text())
        mix.update(upd)
        _json(base / "mixes" / f"{name}.json", mix)
    (base / "metrics" / "requests_per_s.tiny.py").write_text(
        '"""Requests a second over the window."""\n\n\n'
        "def read(rec):\n"
        "    return len(rec.done) / rec.window_s if rec.window_s else None\n")
    man["configs"].append({
        "name": "mesh2d-16", "source": "test", "reduced": [], "why": "test",
        "file": "bcastbench/configs/mesh2d-16.json"})
    for cell, (conf, mix, chips, like) in TINY_CELLS.items():
        man["workloads"].append({"name": cell, "config": conf,
                                 "traffic": mix, "chips": chips,
                                 "why": "test"})
        for m in man["per_layer"]:
            if like in m["workloads"]:
                m["workloads"].append(cell)
    man["per_layer"].append({
        "name": "requests_per_s.tiny", "unit": "1/s", "better": "higher",
        "source": "host_clock", "layer": "entry", "moves": "payload_rate",
        "workloads": list(TINY_CELLS)})
    _json(dest / "BENCHMARK.json", man)
    return dest


@pytest.fixture(scope="session")
def tiny(tmp_path_factory) -> Path:
    return make_tiny(tmp_path_factory.mktemp("checkout"))


def find(tiny: Path, name: str):
    from bcastbench import manifest
    return manifest.find_cell(name, root=tiny, base=tiny / "bcastbench")
