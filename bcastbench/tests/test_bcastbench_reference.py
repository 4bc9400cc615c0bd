"""The reference, the control and the roofline's counts."""

import pytest
import torch

from conftest import find

from bcastbench import reference, roofline
from bcastbench.control import control_bad_bytes


def _want(nbytes=4096, seed=9):
    return reference.expected_copy(seed, nbytes, 0, "cpu", torch.float32)


def test_the_expected_copy_is_the_payload_made_again():
    from bcastbench import traffic
    assert torch.equal(_want().view(torch.uint8), traffic.payload(
        9, 4096, 0, torch.device("cpu"), torch.float32).view(torch.uint8))


@pytest.mark.parametrize("n", [1, 3, 16])
def test_hand_made_copies(n):
    want = _want()
    copies = want.clone() if n == 1 else want.repeat(n, 1)
    assert reference.bad_bytes(copies, want, n) == 0
    raw = copies.view(torch.uint8).view(-1)
    raw[5] ^= 1                                  # one bit of one byte
    assert reference.bad_bytes(copies, want, n) == 1
    raw[-4:] = ~raw[-4:]                         # the last element
    assert reference.bad_bytes(copies, want, n) == 5
    if n > 1:
        copies[n - 1] = 0                        # a node left out
        zeros = int((want.view(torch.uint8) == 0).sum())
        assert reference.bad_bytes(copies, want, n) == 1 + 4096 - zeros


def test_a_result_of_the_wrong_shape_or_type_counts_every_byte():
    want = _want()
    assert reference.bad_bytes(want.repeat(3, 1)[:2], want, 3) == 3 * 4096
    assert reference.bad_bytes(want.view(torch.int32).repeat(3, 1), want,
                               3) == 3 * 4096


@pytest.mark.parametrize("n", [1, 8])
def test_the_control_fails(n):
    want = _want(65536)
    bad = reference.bad_bytes(reference.control_copies(want, n), want, n)
    assert bad > n * 65536 // 4


@pytest.mark.parametrize("cell", ["mesh2d-16.large", "mesh2d-16.one_root"])
def test_the_control_fails_at_a_cells_keep(tiny, cell):
    """The control in the program's place, judged as a run judges the
    program: the bytes that differ are far above the limit, 0."""
    row = control_bad_bytes(find(tiny, cell), 2 ** 31 + 77,
                            torch.device("cpu"))
    assert row["answers"] >= 2
    assert row["bad_bytes"] > 1000


def test_least_bytes_and_the_peak():
    assert roofline.least_bytes(256, 4_000_000) == 1_024_000_000
    assert roofline.HBM_BYTES_PER_S == 3.35e12
    assert "H100" in roofline.HBM_SOURCE and "3.35 TB/s" in \
        roofline.HBM_SOURCE
    assert roofline.least_seconds(3.35e12) == pytest.approx(1.0)
