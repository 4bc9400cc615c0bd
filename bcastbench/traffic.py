"""Requests and payloads, made from ``--seed``.

A mix (``mixes/<name>.json``) is data; its ``generator`` names the code in
``generators/`` that turns it and a seed into an endless stream of
:class:`Request`. Payloads come from a pool made on the device: ``pool``
payloads of each size, each its own seeded random bytes, taken in turn by
the requests of that size, so no two requests in a row of one size send
the same bytes.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Request:
    """The ``index``-th request of a stream: broadcast ``nbytes`` from
    ``root``, with payload ``slot`` of that size's pool."""

    index: int
    root: int
    nbytes: int
    slot: int


def seed_state(seed: int, *key: int) -> int:
    """A 63-bit seed derived from the run's ``seed`` (any whole number) and
    ``key``, the same on every host."""
    ss = np.random.SeedSequence([seed % (1 << 64), *key])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def rng(seed: int, *key: int) -> np.random.Generator:
    return np.random.default_rng(seed_state(seed, *key))


def roots_of(mix: dict, n: int) -> List[int]:
    """The mix's roots on a fabric of ``n`` nodes (``"all"``: every node)."""
    roots = list(range(n)) if mix["roots"] == "all" else \
        [int(r) for r in mix["roots"]]
    bad = [r for r in roots if not 0 <= r < n]
    if bad:
        raise ValueError(f"roots {bad} lie outside the fabric's {n} nodes")
    return roots


def sizes_of(mix: dict, esize: int) -> List[int]:
    sizes = [int(s) for s in mix["sizes"]]
    bad = [s for s in sizes if s <= 0 or s % esize]
    if bad:
        raise ValueError(f"message sizes {bad} are no whole number of "
                         f"{esize}-byte elements")
    return sizes


def with_slots(pairs: Iterator, pool: int) -> Iterator[Request]:
    """Number the ``(root, nbytes)`` pairs and give each the next payload
    slot of its size."""
    used: Dict[int, int] = {}
    for i, (root, nbytes) in enumerate(pairs):
        k = used.get(nbytes, 0)
        used[nbytes] = k + 1
        yield Request(index=i, root=int(root), nbytes=int(nbytes),
                      slot=k % pool)


def payload(seed: int, nbytes: int, slot: int, device: torch.device,
            dtype: torch.dtype) -> torch.Tensor:
    """Payload ``slot`` of size ``nbytes``: seeded random bytes made on
    ``device`` in one call, viewed as ``dtype``."""
    g = torch.Generator(device=device)
    g.manual_seed(seed_state(seed, 1, nbytes, slot))
    raw = torch.randint(0, 256, (nbytes,), dtype=torch.uint8, device=device,
                        generator=g)
    return raw.view(dtype)


def payload_pool(seed: int, sizes: List[int], pool: int,
                 device: torch.device, dtype: torch.dtype
                 ) -> Dict[int, List[torch.Tensor]]:
    return {s: [payload(seed, s, k, device, dtype) for k in range(pool)]
            for s in sizes}
