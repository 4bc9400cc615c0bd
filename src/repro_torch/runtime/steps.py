"""The train step, the port of ``repro.runtime.steps.make_train_step``.

``make_train_step(model, lr, microbatches)`` returns ``train_step(params,
opt, batch) -> (params, opt, metrics)``, the reference's contract, with
``metrics = dict(loss, grad_norm)`` (0-d float32 tensors). ``params`` is
the model's own name -> parameter dict (``dict(model.named_parameters())``):
the loss is ``model.loss(batch)`` on those tensors, and AdamW updates them
in place (``optim.adamw``), so the same dict is returned. With
``microbatches > 1`` the batch is split on dim 0 and each part's gradients
are summed into float32 zeros, as the reference's ``lax.scan`` does; loss
and gradients are then divided by the count. ``grad_norm`` is the global
norm of the gradients before the clip, as in the reference.

The reference's sharding helpers (``param_shardings``, ``opt_shardings``,
...) wait for the sharding slice (ROADMAP queue 1 item 3).
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import torch

from repro_torch.models.model import LM
from repro_torch.optim.adamw import adamw_update, global_norm


def value_and_grad(model: LM, params: Mapping[str, torch.Tensor],
                   batch: Dict) -> Tuple[torch.Tensor, Dict]:
    """``(loss, grads)`` of ``model.loss(batch)``; a parameter the loss does
    not reach gets zeros, as ``jax.grad`` gives."""
    loss = model.loss(batch)
    got = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
    grads = {k: torch.zeros_like(p) if g is None else g
             for (k, p), g in zip(params.items(), got)}
    return loss.detach(), grads


def make_train_step(model: LM, lr: float = 3e-4, microbatches: int = 1):
    """(params, opt, batch) -> (params, opt, metrics) (module docstring).
    Turns the model's gradients on (``LM`` builds its parameters frozen)."""
    model.requires_grad_(True)
    own = dict(model.named_parameters())

    def train_step(params, opt, batch):
        if params.keys() != own.keys() or \
                any(params[k] is not p for k, p in own.items()):
            raise ValueError("params must be the model's own parameters, "
                             "dict(model.named_parameters())")
        if microbatches == 1:
            loss, grads = value_and_grad(model, params, batch)
        else:
            b = batch["tokens"].shape[0]
            if b % microbatches:
                raise ValueError(f"batch {b} does not split into "
                                 f"{microbatches} microbatches")
            m = b // microbatches
            loss = torch.zeros((), dtype=torch.float32, device=model.device)
            grads = {k: torch.zeros(p.shape, dtype=torch.float32,
                                    device=p.device)
                     for k, p in params.items()}
            for i in range(microbatches):
                part = {k: v[i * m:(i + 1) * m] for k, v in batch.items()}
                l, g = value_and_grad(model, params, part)
                loss += l
                for k, acc in grads.items():
                    acc += g[k]
                del g
            loss = loss / microbatches
            for acc in grads.values():
                acc.div_(microbatches)
        params, opt = adamw_update(params, grads, opt, lr=lr)
        return params, opt, dict(loss=loss, grad_norm=global_norm(grads))

    return train_step
