"""The port's round step against the reference's Pallas kernel.

One sub-round of the virtual mesh (``permute_step_ref``) must equal, bit for
bit, the reference's per-device rendering: every device gathers its send
row (``round_step`` with no write), a numpy permute carries it to the
receiver (zeros where no one sends), and every device scatters the
received row (``round_step`` with no read) -- each step through the Pallas
kernel in interpret mode (``use_pallas=True, interpret=True``). Random
float32, int32 and bfloat16 payloads from a numpy seed, random tables, and
the edge cases by hand. Tolerance: exact.
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.device.pallas_step import round_step
from repro_torch.device.round_step import (permute_step, permute_step_ref,
                                           random_table)

DTYPES = {"float32": np.float32, "int32": np.int32,
          "bfloat16": ml_dtypes.bfloat16}


def _payload(rng, dtype, shape):
    f = rng.standard_normal(shape).astype(np.float32)
    if dtype == "int32":
        return (f * 1e6).astype(np.int32)
    return f.astype(DTYPES[dtype])


def _reference_subround(bufs, tab):
    """Per-device Pallas steps around a numpy permute (module docstring)."""
    src, s_ix, s_ok, r_ix, r_ok = (tab[i].tolist() for i in range(5))
    n = len(bufs)
    vals = []
    for v in range(n):
        _, val = round_step(jnp.asarray(bufs[v]), jnp.zeros_like(bufs[v][0]),
                            0, False, s_ix[v], bool(s_ok[v]),
                            use_pallas=True, interpret=True)
        vals.append(np.asarray(val))
    out = []
    for v in range(n):
        rec = vals[src[v]] if src[v] >= 0 else np.zeros_like(bufs[v][0])
        b, _ = round_step(jnp.asarray(bufs[v]), jnp.asarray(rec), r_ix[v],
                          bool(r_ok[v]), 0, False, use_pallas=True,
                          interpret=True)
        out.append(np.asarray(b))
    return out


def _to_port(bufs):
    """Per-device ``[rows, plen]`` arrays -> one ``[n, rows, row_bytes]``
    uint8 tensor, rows padded to 16 bytes."""
    raw = np.stack(bufs).view(np.uint8)
    n, rows, used = raw.shape
    out = np.zeros((n, rows, -(-used // 16) * 16), dtype=np.uint8)
    out[:, :, :used] = raw
    return torch.from_numpy(out), used


def _edge_table(n, rows):
    """n=5: 0 -> 1 a plain move from the last row into the first; 1 -> 2 a
    write whose read is masked off (the relay zero-write), so device 1
    sends and receives, on different rows; 3 receives from no one but
    writes (zeros); 3 -> 4 has both masks off."""
    assert n == 5
    src = [-1, 0, 1, -1, 3]
    s_ix = [rows - 1, 2, 0, 0, 1]
    s_ok = [1, 0, 1, 0, 0]
    r_ix = [0, 0, rows - 1, 1, 2]
    r_ok = [0, 1, 1, 1, 0]
    return np.array([src, s_ix, s_ok, r_ix, r_ok], dtype=np.int32)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_permute_step_matches_pallas_reference(dtype):
    rng = np.random.default_rng({"float32": 0, "int32": 1,
                                 "bfloat16": 2}[dtype])
    n, rows, plen = 5, 4, 7
    bufs = list(_payload(rng, dtype, (n, rows, plen)))
    port, used = _to_port(bufs)
    tables = [_edge_table(n, rows)] + \
        [random_table(rng, n, rows) for _ in range(3)]
    for tab in tables:
        bufs = _reference_subround(bufs, tab)
        permute_step_ref(port, torch.from_numpy(tab))
        want, _ = _to_port(bufs)
        assert torch.equal(port, want), tab
    # the CPU wrapper takes the plain path and agrees
    again, _ = _to_port(bufs)
    tab = torch.from_numpy(random_table(rng, n, rows))
    assert torch.equal(permute_step(again.clone(), tab),
                       permute_step_ref(again.clone(), tab))


@pytest.mark.parametrize("seed", range(6))
def test_random_tables_keep_the_in_place_property(seed):
    """``random_table`` draws real edge cases and never a device that sends
    and receives one row, the property the in-place kernel needs."""
    rng = np.random.default_rng(seed)
    n, rows = 64, 1 + seed
    for _ in range(20):
        src, s_ix, s_ok, r_ix, r_ok = random_table(rng, n, rows)
        live = src[src >= 0]
        assert len(set(live.tolist())) == len(live)          # a matching
        assert ((0 <= s_ix) & (s_ix < rows)).all()
        assert ((0 <= r_ix) & (r_ix < rows)).all()
        senders = np.zeros(n, dtype=bool)
        senders[live] = True
        assert not (senders & (s_ok != 0) & (r_ok != 0)
                    & (s_ix == r_ix)).any()


def test_plain_step_reads_before_it_writes():
    """Every read sees the buffer from before the sub-round: device 1 sends
    its row 0 to device 2 while it receives device 0's row 0 into row 1."""
    buf = torch.arange(3 * 2 * 16, dtype=torch.uint8).reshape(3, 2, 16)
    orig = buf.clone()
    # 0 -> 1 (row 0 into row 1), 1 -> 2 (row 0 into row 1), all live
    tab = torch.tensor([[-1, 0, 1], [0, 0, 0], [1, 1, 0],
                        [0, 1, 1], [0, 1, 1]], dtype=torch.int32)
    permute_step_ref(buf, tab)
    assert torch.equal(buf[1, 1], orig[0, 0])
    assert torch.equal(buf[2, 1], orig[1, 0])
    assert torch.equal(buf[0], orig[0])
