"""``BENCHMARK.json`` and the files it names, found by name.

A cell (an entry of ``workloads``) names a configuration and a traffic
mix; each lives in a file of its own under this directory:

* ``configs/<file>``: the configuration's ``file`` in ``configs``;
* ``mixes/<traffic>.json``: the mix, whose ``generator`` names
  ``generators/<generator>.py``;
* ``metrics/<metric>.py``: one reader for each metric, end-to-end and
  per-layer alike, with ``read(rec) -> float | None``.

Later cells and metrics are added as files and entries; nothing here
changes for them.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

HERE = Path(__file__).resolve().parent


@dataclasses.dataclass
class Cell:
    """One workload of ``BENCHMARK.json`` with what it names, loaded."""

    name: str
    chips: int
    workload: dict
    config: dict
    mix: dict
    end_to_end: List[dict]
    per_layer: List[dict]
    base: Path

    def metrics(self, trace: bool) -> List[dict]:
        """The metrics a run reports: the per-layer ones with a trace, the
        end-to-end ones without."""
        return self.per_layer if trace else self.end_to_end

    def reader(self, metric: str) -> ModuleType:
        return load_module(self.base / "metrics" / f"{metric}.py")

    def generator(self) -> ModuleType:
        return load_module(
            self.base / "generators" / f"{self.mix['generator']}.py")


def load_module(path: Path) -> ModuleType:
    """The module in ``path``, loaded by its file (a metric's name has dots
    in it, so it is no importable module name)."""
    if not path.is_file():
        raise FileNotFoundError(f"no file {path}")
    spec = importlib.util.spec_from_file_location(
        f"bcastbench_file_{path.stem.replace('.', '_').replace('-', '_')}",
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_manifest(root: Path) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def find_cell(name: str, root: Optional[Path] = None,
              base: Optional[Path] = None) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json`` (the checkout's root by
    default), with its configuration, mix and metrics; ``base`` is the
    directory that holds ``configs``, ``mixes``, ``generators`` and
    ``metrics`` (this one by default). Raises ``KeyError`` for an unknown
    cell."""
    base = HERE if base is None else Path(base)
    root = base.parent if root is None else Path(root)
    man = load_manifest(root)
    cells: Dict[str, dict] = {w["name"]: w for w in man["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in {root / 'BENCHMARK.json'}; "
                       f"there are {sorted(cells)}")
    w = cells[name]
    conf = {c["name"]: c for c in man["configs"]}[w["config"]]
    with open(root / conf["file"]) as f:
        config = json.load(f)
    with open(base / "mixes" / f"{w['traffic']}.json") as f:
        mix = json.load(f)
    return Cell(name=name, chips=int(w["chips"]), workload=w, config=config,
                mix=mix,
                end_to_end=[m for m in man["end_to_end"] if _applies(m, name)],
                per_layer=[m for m in man["per_layer"] if _applies(m, name)],
                base=base)
