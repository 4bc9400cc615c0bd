"""The runner's copy out of the packet buffers (``runner.unpack``).

On the CPU ``unpack`` runs the plain two-copy version ``unpack_ref`` and
never touches ``nvcc``; on a GPU it launches ``csrc/unpack_rows.cu``
through ``unpack_rows``, whose argument checks all raise before a build or
a launch. ``_model_unpack_rows`` repeats the kernel's chunk arithmetic in
numpy (its segments, the 16-byte chunks each owns, the word selection and
funnel shift of an inside chunk, the byte walk of the chunk past a
segment's end), so the CPU holds the design to the plain version on every
layout of ``tests/unpack_cases.py``, the table the card tests
(``tests/test_torch_cuda.py``) hold the kernel itself on. Tolerance:
exact.
"""

import numpy as np
import pytest
import torch

from repro_torch.device import runner
from repro_torch.device.runner import PacketLayout
from unpack_cases import LAYOUTS, REAL, layout, layout_id


def _random_buf(lay, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(
        0, 256, (lay.n, lay.rows, lay.row_bytes), dtype=np.uint8))


def _two_copies(buf, lay, nbytes):
    """``unpack``'s copy as it was before the kernel, verbatim: the pin
    that the new ``unpack`` is held to."""
    out = torch.empty((lay.n, nbytes), dtype=torch.uint8, device=buf.device)
    full, rem = divmod(nbytes, lay.used)
    out[:, :full * lay.used].view(lay.n, full, lay.used).copy_(
        buf[:, :full, :lay.used])
    if rem:
        out[:, full * lay.used:] = buf[:, full, :rem]
    return out


def _model_unpack_rows(buf: np.ndarray, lay: PacketLayout, nbytes: int
                       ) -> np.ndarray:
    """``csrc/unpack_rows.cu`` in numpy, item by item: returns the output
    and asserts that every byte is written exactly once and that no load
    leaves its row."""
    n, rows, row_bytes = buf.shape
    used = lay.used
    full, rem = divmod(nbytes, used)
    segs = full + (rem > 0)
    total = n * nbytes
    flat = buf.reshape(-1)
    out = np.zeros(total, dtype=np.uint8)
    writes = np.zeros(total, dtype=np.int64)
    for item in range(n * segs):
        v, r = divmod(item, segs)
        start = v * nbytes + r * used
        length = used if r < full else rem
        end = start + length
        row = v * rows * row_bytes + r * row_bytes
        k0, k1 = (start + 15) >> 4, end >> 4
        col = 16 * k0 - start
        assert 0 <= col < 16
        sh = col
        count = k1 - k0
        if count > 0:
            chunks = flat[row:row + row_bytes].reshape(-1, 16)
            i = np.arange(count)
            if sh == 0:
                got = chunks[i]
            else:
                assert count < len(chunks)       # src[i + 1] in the row
                w = np.concatenate([chunks[i], chunks[i + 1]], axis=1) \
                    .view("<u4").astype(np.uint64)            # [count, 8]
                q, shift = sh >> 2, np.uint64(8 * (sh & 3))
                lo, hi = w[:, q:q + 4], w[:, q + 1:q + 5]
                got = ((((hi << np.uint64(32)) | lo) >> shift)
                       & np.uint64(0xFFFFFFFF)).astype("<u4").view(np.uint8)
            at = 16 * (k0 + i)[:, None] + np.arange(16)[None]
            out[at] = got
            writes[at] += 1
        if end & 15 and k1 >= k0:
            for lane in range(16):
                p = 16 * k1 + lane
                if p >= total:
                    break
                vv, rr, c, ln = v, r, p - start, length
                while c >= ln:
                    c -= ln
                    rr += 1
                    if rr == segs:
                        rr, vv = 0, vv + 1
                    ln = used if rr < full else rem
                out[p] = flat[vv * rows * row_bytes + rr * row_bytes + c]
                writes[p] += 1
    assert (writes == 1).all()
    return out.reshape(n, nbytes)


@pytest.mark.parametrize("case", LAYOUTS, ids=layout_id)
def test_kernel_model_equals_plain_version(case):
    lay, nbytes = layout(*case)
    buf = _random_buf(lay, nbytes)
    want = runner.unpack_ref(buf, lay, nbytes)
    got = _model_unpack_rows(buf.numpy(), lay, nbytes)
    assert np.array_equal(got, want.numpy())


@pytest.mark.parametrize("total,used,row_bytes", [r[:3] for r in REAL])
@pytest.mark.parametrize("rem", [False, True])
def test_kernel_model_on_the_cells_rows(total, used, row_bytes, rem):
    """The cells' row lengths and paddings on three devices of four rows:
    three whole rows, and a fourth cut short or left out."""
    nbytes = 3 * used + (rem and (used * 7 // 16) // 4 * 4)
    lay = PacketLayout(n=3, total=4, relay=0, plen=used // 4, used=used,
                       row_bytes=row_bytes)
    buf = _random_buf(lay, total)
    want = runner.unpack_ref(buf, lay, nbytes)
    got = _model_unpack_rows(buf.numpy(), lay, nbytes)
    assert np.array_equal(got, want.numpy())


@pytest.fixture
def no_nvcc(monkeypatch):
    """Any build or load of a kernel fails the test."""
    from repro_torch import nvcc

    def refuse(*a, **k):
        raise AssertionError("nvcc touched on the CPU path")

    monkeypatch.setattr(nvcc, "load", refuse)
    monkeypatch.setattr(nvcc, "build", refuse)
    monkeypatch.setattr(runner, "_unpack_fn", None)


@pytest.mark.parametrize("case", LAYOUTS, ids=layout_id)
def test_unpack_on_cpu_is_the_plain_copy(no_nvcc, case):
    """``unpack`` on a CPU buffer is ``unpack_ref``: the old two copies'
    bytes, in ``x``'s dtype and shape, a fresh tensor; no build and no
    launch counted."""
    lay, nbytes = layout(*case)
    buf = _random_buf(lay, 3)
    x = torch.empty(case[5], dtype=getattr(torch, case[0]))
    before = (runner.unpack_launches, runner.unpack_bytes)
    out = runner.unpack(buf, lay, x)
    assert out.dtype == x.dtype and out.shape == (lay.n,) + tuple(x.shape)
    assert out.is_contiguous()
    assert out.untyped_storage().data_ptr() != \
        buf.untyped_storage().data_ptr()
    assert torch.equal(out.reshape(lay.n, -1).view(torch.uint8),
                       _two_copies(buf, lay, nbytes))
    assert (runner.unpack_launches, runner.unpack_bytes) == before


def _bad(what):
    lay, nbytes = layout("float32", 4, 5, 0, 1001, 4 * 1001 + 9)
    buf = torch.zeros((lay.n, lay.rows, lay.row_bytes), dtype=torch.uint8)
    if what == "on_the_cpu":
        return buf, lay, nbytes
    if what == "not_contiguous":
        wide = torch.zeros((lay.n, lay.rows + 1, lay.row_bytes),
                           dtype=torch.uint8)
        return wide[:, 1:], lay, nbytes
    if what == "row_not_16":
        lay = PacketLayout(n=4, total=5, relay=0, plen=5, used=20,
                           row_bytes=20)
        return torch.zeros((4, 5, 20), dtype=torch.uint8), lay, 80
    if what == "not_uint8":
        return buf.view(torch.int32), lay, nbytes
    if what == "other_shape":
        return buf[:3].clone(), lay, nbytes
    if what == "too_many_bytes":
        return buf, lay, lay.total * lay.used + 4
    if what == "used_past_row":
        lay = PacketLayout(n=4, total=5, relay=0, plen=5, used=40,
                           row_bytes=32)
        return torch.zeros((4, 5, 32), dtype=torch.uint8), lay, 80
    raise KeyError(what)


@pytest.mark.parametrize("what", ["on_the_cpu", "not_contiguous",
                                  "row_not_16", "not_uint8", "other_shape",
                                  "too_many_bytes", "used_past_row"])
def test_unpack_rows_checks_raise_before_any_launch(no_nvcc, what):
    buf, lay, nbytes = _bad(what)
    before = (runner.unpack_launches, runner.unpack_bytes)
    with pytest.raises(ValueError):
        runner.unpack_rows(buf, lay, nbytes)
    assert (runner.unpack_launches, runner.unpack_bytes) == before
    assert runner._unpack_fn is None


@pytest.mark.parametrize("fabric", ["ring8", "hypercube3", "mesh2d_4x4"])
def test_unpack_equals_two_copies_on_real_plans(no_nvcc, fabric):
    """The real layouts of BBS and baseline plans, relay rows included, in
    ``test_compacted_rounds_on_real_plans``' manner: after the cycle loop,
    and on a buffer of random bytes (padding and relay rows too), the new
    ``unpack`` equals the old two copies and the kernel's model."""
    from repro_torch import api
    from repro_torch.core import topology as T
    from repro_torch.core.simconfig import DeviceConfig, SimConfig

    topo = {"ring8": lambda: T.ring(8), "hypercube3": lambda: T.hypercube(3),
            "mesh2d_4x4": lambda: T.mesh2d(4, 4)}[fabric]()
    cpu = SimConfig(device=DeviceConfig(device="cpu"))
    model = api.compile(topo)
    for algo, nbytes, dtype in (("bbs", 1 << 16, torch.float32),
                                ("bbs", (1 << 12) + 6, torch.bfloat16),
                                ("bine_tree", (1 << 12) + 3, torch.uint8)):
        ex = model.executable(root=1, nbytes=nbytes, algo=algo, config=cpu)
        x = torch.from_numpy(np.random.default_rng(nbytes).integers(
            0, 256, nbytes, dtype=np.uint8)).view(dtype)
        low = ex.lowered                 # the tables' staged layout
        plc = low.placement(x)
        lay, buf = plc.lay, low.start(x, plc, None)
        low.cycles(buf, plc, None)
        for b in (buf, _random_buf(lay, nbytes)):
            out = runner.unpack(b, lay, x).view(torch.uint8).reshape(
                lay.n, -1)
            assert torch.equal(out, _two_copies(b, lay, nbytes)), (
                fabric, algo)
            assert np.array_equal(
                _model_unpack_rows(b.numpy(), lay, nbytes), out.numpy())
            if b is buf:                 # every device holds the payload
                assert torch.equal(out, x.view(torch.uint8).expand(
                    lay.n, -1))
