"""The plain reference of a broadcast, and the comparison that decides
``correct``.

A broadcast of a payload from its root leaves every node holding the
payload, bit for bit (the configurations' ``guarantee``). So the expected
copy of every node is the payload itself, made again here from the run's
seed (``traffic.payload``), and a delivered copy is judged by the number
of its bytes that differ from it. The limit is 0: the comparison is
exact.

The control is this reference put in the program's place in the nearest
precision below the configurations' float32: each node's copy is the
payload rounded to bfloat16 and back (``control_copies``). It has to come
out as not correct.

Plain PyTorch only; nothing of the program is imported.
"""

from __future__ import annotations

import torch

from bcastbench import traffic


def expected_copy(seed: int, nbytes: int, slot: int, device,
                  dtype: torch.dtype) -> torch.Tensor:
    """What every node holds after the broadcast of payload ``slot`` of
    size ``nbytes``: that payload, made again from the seed."""
    return traffic.payload(seed, nbytes, slot, torch.device(device), dtype)


def bad_bytes(copies: torch.Tensor, want: torch.Tensor, n: int,
              block: int = 16) -> int:
    """How many bytes of the ``n`` delivered ``copies`` (shape ``(n,) +
    want.shape``; ``want.shape`` alone for ``n == 1``) differ from
    ``want``, counted ``block`` copies at a time so that the count fits
    beside them. A result of the wrong shape or type counts every byte."""
    shape = tuple(want.shape) if n == 1 else (n,) + tuple(want.shape)
    nb = want.numel() * want.element_size()
    if tuple(copies.shape) != shape or copies.dtype != want.dtype:
        return n * nb
    got = copies.reshape(n, -1)
    ref = want.contiguous().reshape(1, -1).view(torch.uint8).to(got.device)
    bad = 0
    for i in range(0, n, block):
        part = got[i:i + block].contiguous().view(torch.uint8)
        bad += int((part != ref).sum().item())
    return bad


def control_copies(want: torch.Tensor, n: int) -> torch.Tensor:
    """The control: the reference's ``n`` copies computed in bfloat16, the
    precision below the payloads' float32 (a view of one row, ``n`` times;
    ``want.shape`` alone for ``n == 1``)."""
    row = want.to(torch.bfloat16).to(want.dtype)
    return row if n == 1 else row.unsqueeze(0).expand((n,) + tuple(row.shape))
