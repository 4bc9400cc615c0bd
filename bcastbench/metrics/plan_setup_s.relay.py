"""``plan_setup_s`` read in the butterfly's cell, whose two-tree
plans carry relay rows: the reader beside this file, loaded by its path,
so that the cells read the same thing."""

from pathlib import Path

from bcastbench.manifest import load_module

_base = load_module(Path(__file__).with_name("plan_setup_s.py"))


def read(rec):
    return _base.read(rec)
