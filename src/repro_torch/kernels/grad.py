"""A gradient for the hand-written kernels: the kernel forward, the plain
backward.

The reference has no backward kernel to port: its models run the plain XLA
path under ``jax.value_and_grad``. So K2 (``flash_attention``) and K3
(``ssd_scan``) get one ``torch.autograd.Function``, ``KernelGrad``: its
forward launches the kernel and saves the inputs; its backward recomputes
the plain version (``ref.attention_ref`` or ``ref.ssd_chunked``) under
autograd on detached copies of the inputs and returns
``torch.autograd.grad`` of it against the incoming gradient. The input
gradients are therefore exactly autograd's through the plain version on
the same inputs, in the inputs' dtypes; the forward's output is the
kernel's. The recompute holds one call's plain intermediates (attention's
float32 logits: about 2 GB at llama3.2-3b's 4 x 2048 prefill) while that
call's backward runs.

The wrappers call ``kernel_with_grad``, which takes this route only when
grad is enabled and an input requires grad; otherwise it calls the kernel
directly, so serving pays no ``Function.apply`` on a decode step. Both
routes launch the kernel and count it.
"""

from __future__ import annotations

from typing import Callable

import torch


class KernelGrad(torch.autograd.Function):
    """``KernelGrad.apply(kernel, plain, *inputs)``: ``kernel(*inputs)``
    forward, autograd through ``plain(*inputs)`` backward (module
    docstring). ``kernel`` and ``plain`` take the tensors only; bind any
    other argument (``causal``, ``scale``, ``chunk``) into both."""

    @staticmethod
    def forward(ctx, kernel: Callable, plain: Callable,
                *inputs: torch.Tensor) -> torch.Tensor:
        ctx.plain = plain
        ctx.save_for_backward(*inputs)
        return kernel(*inputs)

    @staticmethod
    def backward(ctx, grad_out: torch.Tensor):
        need = ctx.needs_input_grad[2:]
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(n)
                      for t, n in zip(ctx.saved_tensors, need)]
            out = ctx.plain(*leaves)
        wanted = [t for t, n in zip(leaves, need) if n]
        grads = iter(torch.autograd.grad(out, wanted, grad_out))
        return (None, None, *(next(grads) if n else None for n in need))


def kernel_with_grad(kernel: Callable, plain: Callable,
                     *inputs: torch.Tensor) -> torch.Tensor:
    """``kernel(*inputs)``; through ``KernelGrad`` when grad is enabled and
    an input requires grad."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in inputs):
        return KernelGrad.apply(kernel, plain, *inputs)
    return kernel(*inputs)
