"""AdamW over a dict of tensors, the port of ``repro.optim.adamw``.

The reference's math and names: float32 first and second moments ``mu``
and ``nu`` and an int32 ``step``; a global-norm clip over all gradients in
float32; b1 0.9, b2 0.95, eps 1e-8, weight decay 0.1 inside ``delta``;
the update computed in float32 and cast back to each parameter's dtype.
Where the reference returns new trees, ``adamw_update`` writes the
parameters and the state in place under ``torch.no_grad()``, one tensor at
a time, so a step holds a few float32 temporaries of the largest tensor
(1.6 GB for llama3.2-3b's embedding) beyond the state itself.
``torch.optim.AdamW`` is not used: it updates a bfloat16 parameter in
bfloat16 and has no global clip.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import torch


def adamw_init(params: Mapping[str, torch.Tensor]) -> Dict:
    """``mu`` and ``nu``: float32 zeros shaped like each parameter, on its
    device (on a mesh, placed like it); ``step``: an int32 zero on the
    first parameter's device."""
    def zeros():
        return {k: torch.zeros_like(p, dtype=torch.float32)
                for k, p in params.items()}

    dev = next(iter(params.values())).device
    return dict(mu=zeros(), nu=zeros(),
                step=torch.zeros((), dtype=torch.int32, device=dev))


def global_norm(grads: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """The float32 norm over all gradients, a 0-d tensor on their device."""
    with torch.no_grad():
        gsq = sum(torch.sum(torch.square(g.float())) for g in grads.values())
        return torch.sqrt(gsq)


def adamw_update(params: Mapping[str, torch.Tensor],
                 grads: Mapping[str, torch.Tensor], state: Dict, lr,
                 b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1,
                 grad_clip: float = 1.0) -> Tuple[Mapping, Dict]:
    """One AdamW step, in place (module docstring); returns
    ``(params, state)``."""
    with torch.no_grad():
        step = state["step"]
        step += 1
        gnorm = global_norm(grads)
        clip = torch.full_like(gnorm, grad_clip)
        scale = torch.clamp(clip / (gnorm + 1e-9), max=1.0)
        f32 = dict(dtype=torch.float32, device=step.device)
        bc1 = 1 - torch.pow(torch.tensor(b1, **f32), step)
        bc2 = 1 - torch.pow(torch.tensor(b2, **f32), step)
        for k, p in params.items():
            mu, nu = state["mu"][k], state["nu"][k]
            g = grads[k].float() * scale
            mu.mul_(b1).add_((1 - b1) * g)
            nu.mul_(b2).add_((1 - b2) * g * g)
            del g
            pf = p.float()
            delta = mu / bc1
            delta.div_(torch.sqrt(nu / bc2).add_(eps))
            delta.add_(weight_decay * pf)
            p.copy_(pf - lr * delta)
    return params, state
