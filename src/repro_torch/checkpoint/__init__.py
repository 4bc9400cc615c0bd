"""Checkpoints, ported from ``repro.checkpoint``."""

from repro_torch.checkpoint.store import (CheckpointManager,  # noqa: F401
                                          latest_step, load_checkpoint,
                                          save_checkpoint)
