"""Config registry: one module per assigned architecture (+ paper demo).
A copy of the reference's ``configs`` package with the imports rewritten.

``get_config(name)`` returns the full ModelConfig; ``--arch`` ids match the
assignment table. Smoke variants: ``get_config(name).smoke()``.
"""

from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.configs.base import (LONG_CONTEXT_FAMILIES, SHAPES,
                                      ModelConfig, ShapeCell)

ARCHS: List[str] = [
    "mamba2-370m",
    "seamless-m4t-large-v2",
    "granite-moe-1b-a400m",
    "arctic-480b",
    "stablelm-1.6b",
    "llama3.2-3b",
    "granite-8b",
    "yi-34b",
    "llava-next-mistral-7b",
    "zamba2-7b",
]

_MODULES = {
    "mamba2-370m": "mamba2_370m",
    "seamless-m4t-large-v2": "seamless_m4t_large_v2",
    "granite-moe-1b-a400m": "granite_moe_1b_a400m",
    "arctic-480b": "arctic_480b",
    "stablelm-1.6b": "stablelm_1_6b",
    "llama3.2-3b": "llama3_2_3b",
    "granite-8b": "granite_8b",
    "yi-34b": "yi_34b",
    "llava-next-mistral-7b": "llava_next_mistral_7b",
    "zamba2-7b": "zamba2_7b",
}


def get_config(name: str) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
    return mod.CONFIG


def cells(arch: str) -> List[str]:
    """Shape cells applicable to this arch (long_500k only for sub-quadratic
    families; skips are recorded, not silently dropped)."""
    cfg = get_config(arch)
    out = []
    for s in SHAPES:
        if s == "long_500k" and cfg.family not in LONG_CONTEXT_FAMILIES:
            continue
        out.append(s)
    return out


def skipped_cells(arch: str) -> List[str]:
    cfg = get_config(arch)
    return [s for s in SHAPES
            if s == "long_500k" and cfg.family not in LONG_CONTEXT_FAMILIES]
