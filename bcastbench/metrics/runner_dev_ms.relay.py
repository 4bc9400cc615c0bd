"""``runner_dev_ms.large`` read in the butterfly's cell, whose two-tree
plans carry relay rows: the ``.large`` reader beside this file, loaded by
its path, so that the two cells read the same thing."""

from pathlib import Path

from bcastbench.manifest import load_module

_large = load_module(Path(__file__).with_name("runner_dev_ms.large.py"))


def read(rec):
    return _large.read(rec)
