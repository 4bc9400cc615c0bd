"""The least bytes of a broadcast and the card's peak, for the roofline
shares.

Least bytes: the payload read once and ``n - 1`` copies written, so
``n * nbytes`` for a broadcast of ``nbytes`` to ``n`` nodes. The count
holds whatever schedule or kernel does the work, so a share against it
still bounds a claim once K1 is replaced.

Peak: NVIDIA H100 Tensor Core GPU data sheet, SXM5 part, 80 GB HBM3 at
3.35 TB/s, at the card's full 700 W power limit; a run prints the card's
``power.limit`` beside its numbers.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
HBM_SOURCE = ("NVIDIA H100 Tensor Core GPU data sheet, H100 SXM: 80 GB "
              "HBM3, 3.35 TB/s memory bandwidth (at 700 W)")


def least_bytes(n: int, nbytes: int) -> int:
    """Bytes a broadcast of ``nbytes`` to ``n`` nodes must read and write:
    the payload once and ``n - 1`` copies."""
    return n * nbytes


def least_seconds(total_bytes: float) -> float:
    return total_bytes / HBM_BYTES_PER_S
