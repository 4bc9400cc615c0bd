"""Deterministic synthetic data pipeline.

Produces reproducible token batches keyed by (seed, step) — restart-safe: a
resumed run at step k sees exactly the batches of an uninterrupted run. The
generator mimics Zipfian token statistics with short-range structure so the
LM loss has signal (pure uniform tokens give flat loss).

The numpy generation is the reference's (``repro.data.pipeline``), draw for
draw, so a (seed, step) gives the same tokens in both packages; the batch
holds CPU tensors (tokens int32, patches and frames float32), which the
model moves to its device. ``batch_logical_dims`` and ``make_batch_specs``
are the reference's: the logical dims of a batch for the sharding rules,
and a cell's inputs as ``(shape, dtype)`` stand-ins.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ShapeCell


@dataclasses.dataclass
class SyntheticTokens:
    cfg: ModelConfig
    seq_len: int
    global_batch: int
    seed: int = 0

    def batch(self, step: int) -> Dict[str, torch.Tensor]:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step]))
        v = self.cfg.vocab
        b, s = self.global_batch, self.seq_len
        # zipf-ish marginal + markov-ish repetition structure
        base = rng.zipf(1.3, size=(b, s)).astype(np.int64) % v
        rep = rng.random((b, s)) < 0.3
        shifted = np.roll(base, 1, axis=1)
        toks = np.where(rep, shifted, base)
        batch = dict(tokens=torch.from_numpy(toks.astype(np.int32)))
        if self.cfg.family == "vlm":
            p = rng.standard_normal(
                (b, self.cfg.num_patches, self.cfg.d_model)) * 0.02
            batch["patches"] = torch.from_numpy(p.astype(np.float32))
        if self.cfg.family == "encdec":
            f = rng.standard_normal((b, s, self.cfg.d_model)) * 0.02
            batch["frames"] = torch.from_numpy(f.astype(np.float32))
        return batch


def batch_logical_dims(cfg: ModelConfig) -> Dict[str, tuple]:
    dims = dict(tokens=("batch", "seq"))
    if cfg.family == "vlm":
        dims["patches"] = ("batch", None, None)
    if cfg.family == "encdec":
        dims["frames"] = ("batch", "seq", None)
    return dims


def make_batch_specs(cfg: ModelConfig, cell: ShapeCell,
                     for_decode: bool = False) -> Dict:
    """``(shape, dtype)`` stand-ins for a cell's inputs (the dry-run's)."""
    b, s = cell.global_batch, cell.seq_len
    if for_decode:
        return dict(tokens=((b, 1), torch.int32))
    out = dict(tokens=((b, s), torch.int32))
    if cfg.family == "vlm":
        out["tokens"] = ((b, s - cfg.num_patches), torch.int32)
        out["patches"] = ((b, cfg.num_patches, cfg.d_model), torch.float32)
    if cfg.family == "encdec":
        # half the budget on source frames, half on target tokens
        out["tokens"] = ((b, s // 2), torch.int32)
        out["frames"] = ((b, s // 2, cfg.d_model), torch.float32)
    return out
