"""Weights carried across from the reference.

The reference's LM parameters -- the tree ``repro.models.model.LM.init``
returns, as nested dicts of numpy arrays -- become the port's ``LM`` state,
key for key: ``tree["mamba"]["in_x"]`` is ``model.mamba["in_x"]``
(state-dict key ``mamba.in_x``). Every shape and dtype is checked, and a
missing or extra key raises. bfloat16 arrays (numpy's ``ml_dtypes``
bfloat16) are carried bit for bit.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from repro_torch.models.model import LM


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, Mapping):
            out.update(_flatten(v, key + "."))
        else:
            out[key] = np.asarray(v)
    return out


def _to_torch(a: np.ndarray) -> torch.Tensor:
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(a).view(np.uint16)
                                .copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def import_lm_params(model: LM, tree: Mapping) -> LM:
    """Load the reference's parameter tree into ``model`` (in place); returns
    ``model``."""
    flat = {k: _to_torch(v) for k, v in _flatten(tree).items()}
    state = model.state_dict()
    missing = sorted(set(state) - set(flat))
    extra = sorted(set(flat) - set(state))
    if missing or extra:
        raise KeyError(f"parameter trees differ: missing {missing}, "
                       f"extra {extra}")
    for k, t in flat.items():
        want = state[k]
        if tuple(t.shape) != tuple(want.shape) or t.dtype != want.dtype:
            raise ValueError(f"{k}: got {t.dtype} {tuple(t.shape)}, the "
                             f"model has {want.dtype} {tuple(want.shape)}")
    with torch.no_grad():
        for k, t in flat.items():
            state[k].copy_(t)
    return model
