"""One client in a closed loop: the next request is sent when the last one
is done.

The mix gives ``roots`` (a list, or ``"all"``) and ``sizes`` in bytes. The
stream is made of blocks, each of which sends every (root, size) pair once
in its own seeded order, so every seed sends the same shapes in the same
proportions. A window ends on a whole block (``block``), so each shape has
the same count in it.
"""

from __future__ import annotations

import itertools
from typing import Iterator

from bcastbench.traffic import Request, rng, roots_of, sizes_of, with_slots


def shapes(mix: dict, n: int, esize: int) -> list:
    """Every (root, size) the stream sends, in the order of one block before
    it is shuffled."""
    return list(itertools.product(roots_of(mix, n), sizes_of(mix, esize)))


def block(mix: dict, n: int, esize: int) -> int:
    """Requests in a block: a window ends after a multiple of it."""
    return len(shapes(mix, n, esize))


def stream(mix: dict, seed: int, n: int, esize: int) -> Iterator[Request]:
    """The mix's endless request stream on ``n`` nodes, payloads of
    ``esize``-byte elements."""
    pairs = shapes(mix, n, esize)
    g = rng(seed, 2)

    def blocks():
        while True:
            for i in g.permutation(len(pairs)):
                yield pairs[i]
    return with_slots(blocks(), int(mix["pool"]))
