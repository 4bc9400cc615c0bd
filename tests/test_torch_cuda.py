"""Port tests that need an NVIDIA GPU (marker ``cuda``): the hand-written
kernels (the round step K1 -- one sub-round a launch, and every sub-round
of a broadcast in one persistent launch, also as the calibration's ring
rounds --, the runner's copy out ``unpack_rows``, flash attention K2, the
SSD scan K3, the simulator's event core) against their plain PyTorch
versions, small broadcasts on the card against the same broadcasts on the
CPU, the calibration across the GPUs of
an NCCL group (two GPUs or more), and the LMs of every family on the
card against the CPU. They skip on a host
without a GPU; on the card run them with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from unpack_cases import LAYOUTS, REAL, layout, layout_id

pytestmark = pytest.mark.cuda


@pytest.fixture
def gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int32"])
@pytest.mark.parametrize("n,rows,plen", [(8, 5, 7), (64, 33, 1000),
                                         (3, 1, 4)])
def test_kernel_matches_plain(gpu, dtype, n, rows, plen):
    """Bit-exact, on random payloads and random tables with every edge case
    (``random_table``), applied in sequence to one buffer."""
    from repro_torch.device import round_step as rs

    rng = np.random.default_rng(n * 1000 + rows)
    f = rng.standard_normal((n, rows, plen)).astype(np.float32)
    vals = torch.from_numpy(f * 1e3 if dtype == "int32" else f)
    raw = vals.to(getattr(torch, dtype)).view(torch.uint8)
    row_bytes = -(-raw.shape[2] // 16) * 16
    buf = torch.zeros((n, rows, row_bytes), dtype=torch.uint8)
    buf[:, :, :raw.shape[2]] = raw
    ref, got = buf.clone(), buf.to(gpu)
    before = rs.launches
    for _ in range(4):
        tab = torch.from_numpy(rs.random_table(rng, n, rows))
        rs.permute_step_ref(ref, tab)
        rs.permute_step(got, tab.to(gpu))
    torch.cuda.synchronize()
    assert rs.launches == before + 4
    assert torch.equal(got.cpu(), ref)


def test_kernel_rejects_bad_inputs(gpu):
    from repro_torch.device.round_step import permute_step

    tab = torch.zeros((5, 2), dtype=torch.int32, device=gpu)
    with pytest.raises(ValueError):          # row not a multiple of 16 bytes
        permute_step(torch.zeros((2, 3, 20), dtype=torch.uint8,
                                 device=gpu), tab)
    with pytest.raises(ValueError):          # table on another device
        permute_step(torch.zeros((2, 3, 16), dtype=torch.uint8, device=gpu),
                     tab.cpu())


def test_kernel_in_cuda_graph(gpu):
    """Launches on the current stream, so a CUDA graph captures them (the
    smoke run times the kernel from a captured main-path loop)."""
    from repro_torch.device import round_step as rs

    rng = np.random.default_rng(5)
    n, rows = 16, 9
    buf = torch.randint(0, 256, (n, rows, 64), dtype=torch.uint8,
                        device=gpu)
    ref = buf.cpu()
    tabs = [torch.from_numpy(rs.random_table(rng, n, rows))
            for _ in range(3)]
    dtabs = [t.to(gpu) for t in tabs]
    rs.permute_step(buf.clone(), dtabs[0])     # build and load first
    graph = torch.cuda.CUDAGraph()
    work = buf.clone()
    with torch.cuda.graph(graph):
        for t in dtabs:
            rs.permute_step(work, t)
    work.copy_(buf)
    graph.replay()
    torch.cuda.synchronize()
    for t in tabs:
        rs.permute_step_ref(ref, t)
    assert torch.equal(work.cpu(), ref)


@pytest.mark.parametrize("algo", ["bbs", "bine_tree"])
def test_small_broadcast_on_card_matches_cpu(gpu, algo):
    from repro_torch import api
    from repro_torch.core import topology as T
    from repro_torch.core.simconfig import DeviceConfig, SimConfig
    from repro_torch.device import round_step as rs

    model = api.compile(T.hypercube(3))
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(3000)
                         .astype(np.float32)).to(torch.bfloat16)
    ex = model.executable(root=3, nbytes=6000, algo=algo)
    assert ex.torch_device.type == "cuda"
    before = (rs.launches, rs.rounds_launches, rs.subrounds)
    out = ex.run(x)
    # one permute_rounds launch runs every sub-round; permute_step none
    assert ex.num_launches == 1
    assert (rs.launches, rs.rounds_launches, rs.subrounds) == (
        before[0], before[1] + 1, before[2] + ex.num_subrounds)
    cpu = model.executable(root=3, nbytes=6000, algo=algo, config=SimConfig(
        device=DeviceConfig(device="cpu"))).run(x)
    assert torch.equal(out.cpu().view(torch.int16), cpu.view(torch.int16))
    assert ex.verify(x).ok


@pytest.mark.parametrize("nbytes", [64_000, 1_000_000])
def test_butterfly_relay_broadcast_on_card_matches_cpu(gpu, nbytes):
    """A flattened butterfly's two-tree plan, whose relay chains write and
    read relay rows: on the card in place, one ``fill_inplace`` launch,
    one ``permute_rounds`` launch and one ``unpack_rows`` launch for the
    tail if a row straddles the payload's end, bit-equal to the CPU's
    staged path, and the relay bytes the card's launch counts equal those
    of the same moves run by the plain version on the CPU."""
    from repro_torch import api
    from repro_torch.core import topology as T
    from repro_torch.core.simconfig import DeviceConfig, SimConfig
    from repro_torch.device import round_step as rs
    from repro_torch.device import runner

    model = api.compile(T.butterfly(32))
    ex = model.executable(root=7, nbytes=nbytes)
    assert ex.candidate == "two_tree" and ex.schedule.num_relay > 0
    x = ex.default_payload(seed=32)
    before = (rs.rounds_launches, rs.subrounds, rs.relay_bytes,
              runner.unpack_launches, runner.inplace_runs,
              runner.fill_launches)
    out = ex.run(x)
    torch.cuda.synchronize()
    card_relay = rs.relay_bytes - before[2]
    plc = ex.lowered.placement(x)
    assert plc.inplace and runner.inplace_runs - before[4] == 1
    assert runner.fill_launches - before[5] == 1
    assert (rs.rounds_launches - before[0], rs.subrounds - before[1],
            runner.unpack_launches - before[3]) == (
        1, ex.num_subrounds, int(plc.tail > 0))
    cpu_ex = model.executable(root=7, nbytes=nbytes, config=SimConfig(
        device=DeviceConfig(device="cpu")))
    assert torch.equal(out.cpu().view(torch.uint8),
                       cpu_ex.run(x).view(torch.uint8))
    lay = runner.packet_layout(x, cpu_ex.schedule, cpu_ex.num_groups)
    buf = runner.pack(x, lay, 7, torch.device("cpu"))
    cpu0 = rs.relay_bytes
    rs.permute_rounds(buf, runner.build_moves(
        cpu_ex.schedule, cpu_ex.num_groups, x, "cpu"))
    assert card_relay == rs.relay_bytes - cpu0 > 0
    assert torch.equal(runner.unpack_ref(buf, lay, nbytes),
                       out.cpu().reshape(32, -1).view(torch.uint8))


def _rounds_buffer(gpu, rng, n, rows, row_bytes):
    return torch.from_numpy(rng.integers(0, 256, (n, rows, row_bytes),
                                         dtype=np.uint8)).to(gpu)


def _rounds_tables(rng, n, rows, count, idle_every=3):
    """``count`` random sub-round tables; every ``idle_every``-th has no
    writer (count 0), so its barrier is all it does."""
    from repro_torch.device import round_step as rs

    tabs = np.stack([rs.random_table(rng, n, rows) for _ in range(count)])
    tabs[idle_every - 1::idle_every, 4] = 0
    return tabs


@pytest.mark.parametrize("n,rows,row_bytes,count",
                         [(64, 9, 48, 1), (64, 9, 48, 7), (64, 9, 48, 64),
                          (1, 4, 32, 7), (3, 1, 16, 7), (256, 5, 21744, 7),
                          (17, 33, 1008, 64)])
def test_rounds_kernel_matches_plain(gpu, n, rows, row_bytes, count):
    """``permute_rounds`` bit-identical to ``permute_rounds_ref`` on random
    sequences with every edge case of ``random_table`` and sub-rounds with
    no writer; one launch for all sub-rounds; two launches from the same
    start give the same bytes."""
    from repro_torch.device import round_step as rs

    rng = np.random.default_rng(n * 100 + count)
    tabs = _rounds_tables(rng, n, rows, count)
    moves = rs.compact_moves(tabs, rows)
    assert moves.counts[2::3].sum() == 0
    buf = _rounds_buffer(gpu, rng, n, rows, row_bytes)
    want = rs.permute_rounds_ref(buf.clone(), moves.to(gpu))
    dmoves = moves.to(gpu)
    before = (rs.launches, rs.rounds_launches, rs.subrounds)
    got = rs.permute_rounds(buf.clone(), dmoves)
    again = rs.permute_rounds(buf.clone(), dmoves)
    torch.cuda.synchronize()
    assert (rs.launches, rs.rounds_launches, rs.subrounds) == (
        before[0], before[1] + 2, before[2] + 2 * count)
    assert torch.equal(got, want)
    assert torch.equal(again, got)


def test_rounds_kernel_span_and_barrier_only(gpu):
    """A range [s0, s1) equals the plain version's; a sequence whose every
    count is 0 leaves the buffer as it was (the barriers alone)."""
    from repro_torch.device import round_step as rs

    rng = np.random.default_rng(8)
    n, rows = 32, 6
    tabs = _rounds_tables(rng, n, rows, 40)
    moves = rs.compact_moves(tabs, rows).to(gpu)
    buf = _rounds_buffer(gpu, rng, n, rows, 64)
    got = rs.permute_rounds(buf.clone(), moves, 5, 23)
    want = rs.permute_rounds_ref(buf.clone(), moves, 5, 23)
    assert torch.equal(got, want)
    idle = tabs.copy()
    idle[:, 4] = 0
    got = rs.permute_rounds(buf.clone(), rs.compact_moves(idle, rows).to(gpu))
    torch.cuda.synchronize()
    assert torch.equal(got, buf)
    got = rs.permute_rounds(buf.clone(), moves.idle())
    torch.cuda.synchronize()
    assert torch.equal(got, buf)


@pytest.mark.parametrize("s0,s1", [(0, None), (5, 23)])
def test_rounds_kernel_counts_its_moved_bytes(gpu, s0, s1):
    """``round_step.moved_bytes`` after a real launch equals the bytes the
    moves' pairs ask, counted on the host: a row written a pair, a row read
    a pair that is no zero write."""
    from repro_torch.device import round_step as rs

    rng = np.random.default_rng(31)
    n, rows, row_bytes = 32, 6, 64
    moves = rs.compact_moves(_rounds_tables(rng, n, rows, 40), rows)
    end = moves.num_subrounds if s1 is None else s1
    offs = np.concatenate([[0], np.cumsum(moves.counts)])
    src = moves.pairs[offs[s0]:offs[end], 1].numpy()
    assert (src < 0).any() and (src >= 0).any()
    want = int(len(src) + (src >= 0).sum()) * row_bytes
    buf = _rounds_buffer(gpu, rng, n, rows, row_bytes)
    before = (rs.moved_bytes, rs.rounds_launches)
    rs.permute_rounds(buf, moves.to(gpu), s0, s1)
    torch.cuda.synchronize()
    assert (rs.moved_bytes - before[0], rs.rounds_launches - before[1]) == (
        want, 1)


def test_rounds_kernel_past_2_31_bytes(gpu):
    """A buffer over 2**31 bytes whose last device's last row lies past
    byte 2**31: 64-bit row offsets, bit-identical to the plain version."""
    from repro_torch.device import round_step as rs

    rng = np.random.default_rng(9)
    n, rows, row_bytes = 16, 8200, 16400
    assert n * rows * row_bytes > 2 ** 31
    tabs = _rounds_tables(rng, n, rows, 5)
    for t in tabs:                       # n - 2's last row -> n - 1's last
        src, s_ix, s_ok, r_ix, r_ok = t
        src[src == n - 2] = -1
        src[n - 1], s_ix[n - 2], s_ok[n - 2] = n - 2, rows - 1, 1
        r_ix[n - 1], r_ok[n - 1] = rows - 1, 1
        r_ix[n - 2] = 0 if r_ix[n - 2] == rows - 1 else r_ix[n - 2]
        s_ix[n - 1] = 0 if s_ix[n - 1] == rows - 1 else s_ix[n - 1]
    moves = rs.compact_moves(tabs, rows).to(gpu)
    g = torch.Generator(device=gpu).manual_seed(4)
    buf = torch.randint(0, 256, (n, rows, row_bytes), dtype=torch.uint8,
                        device=gpu, generator=g)
    want = rs.permute_rounds_ref(buf.clone(), moves)
    rs.permute_rounds(buf, moves)
    torch.cuda.synchronize()
    assert torch.equal(buf, want)
    assert torch.equal(buf[n - 1, rows - 1], want[n - 1, rows - 1])


def test_rounds_kernel_rejects_bad_inputs(gpu):
    from repro_torch.device import round_step as rs

    rng = np.random.default_rng(1)
    moves = rs.compact_moves(_rounds_tables(rng, 4, 3, 4), 3)
    buf = torch.zeros((4, 3, 32), dtype=torch.uint8, device=gpu)
    with pytest.raises(ValueError):          # moves on the CPU
        rs.permute_rounds(buf, moves)
    with pytest.raises(ValueError):          # another buffer shape
        rs.permute_rounds(buf[:, :2].contiguous(), moves.to(gpu))
    with pytest.raises(ValueError):          # row not a multiple of 16 bytes
        rs.permute_rounds(torch.zeros((4, 3, 20), dtype=torch.uint8,
                                      device=gpu), moves.to(gpu))
    with pytest.raises(ValueError):          # not a range of the moves
        rs.permute_rounds(buf, moves.to(gpu), 3, 9)
    blocks, threads = rs.rounds_grid(gpu)
    assert blocks >= torch.cuda.get_device_properties(gpu) \
        .multi_processor_count and threads > 0


@pytest.mark.parametrize("layout", ["staged", "inplace", "shuffled"])
def test_rounds_kernel_on_byte_offsets_matches_plain(gpu, layout):
    """K1 on byte offsets (``Moves.offsets``) bit-identical to
    ``permute_rounds_ref`` at the same offsets: the staged buffer's rows on
    its flat view, a real plan's in-place placement (``LoweredPlan``) on a
    random allocation, and random tables' rows shuffled through a larger
    allocation."""
    from repro_torch import api
    from repro_torch.core import topology as T
    from repro_torch.device import round_step as rs
    from repro_torch.device import runner

    rng = np.random.default_rng(77)
    if layout == "inplace":
        ex = api.compile(T.butterfly(32)).executable(root=7, nbytes=1e6)
        x = ex.default_payload(seed=3)
        moves = ex.moves()
        plc = ex.lowered.placement(x)
        assert plc.inplace and plc.lay.relay > 0
        at, size = plc.at, plc.alloc_bytes
    else:
        n, rows, row_bytes = 64, 9, 1008
        moves = rs.compact_moves(_rounds_tables(rng, n, rows, 40),
                                 rows).to(gpu)
        row_at = None
        size = n * rows * row_bytes
        if layout == "shuffled":
            row_at = 32 + rng.permutation(n * rows + 7)[:n * rows] \
                * row_bytes
            size = 32 + (n * rows + 7) * row_bytes
        at = moves.offsets(row_bytes, row_at)
    g = torch.Generator(device=gpu).manual_seed(6)
    alloc = torch.randint(0, 256, (size,), dtype=torch.uint8, device=gpu,
                          generator=g)
    want = rs.permute_rounds_ref(alloc.clone(), moves, at=at)
    before = rs.rounds_launches
    got = rs.permute_rounds(alloc.clone(), moves, at=at)
    torch.cuda.synchronize()
    assert rs.rounds_launches == before + 1
    assert torch.equal(got, want)


def _storage_bytes(t):
    """A flat uint8 view of all of ``t``'s storage."""
    st = t.untyped_storage()
    return torch.empty(0, dtype=torch.uint8, device=t.device).set_(
        st, 0, (st.nbytes(),), (1,))


@pytest.mark.parametrize("cap", ["fitted", 5])
@pytest.mark.parametrize("n,rows,row_bytes,count",
                         [(64, 9, 48, 64), (1, 4, 32, 7), (3, 1, 16, 7),
                          (256, 5, 21744, 7), (17, 33, 1008, 64),
                          (64, 41, 6128, 64)])
def test_rounds_kernel_by_phase_matches_plain(gpu, n, rows, row_bytes,
                                              count, cap):
    """K1 over a whole sequence with its phase table (``with_phases`` for
    its rows, and phases of at most 5 moves) bit-identical to
    ``permute_rounds_ref`` in sub-round order; the library's phase pass
    equal to ``phase_table_ref``; ``subrounds`` grows by the sub-rounds,
    ``phases`` by the phases."""
    import dataclasses

    from repro_torch.device import round_step as rs

    rng = np.random.default_rng(n * 7 + count)
    tabs = _rounds_tables(rng, n, rows, count)
    moves = rs.compact_moves(tabs, rows, max(rows - 2, 1))
    if cap == "fitted":
        phased = rs.with_phases(moves, row_bytes)
        cap = rs.phase_cap(row_bytes)
    else:
        phased = dataclasses.replace(moves, phases=rs.phase_table(moves, cap))
    ref = rs.phase_table_ref(moves, cap)
    assert phased.phases.offs.tolist() == ref.offs.tolist()
    assert torch.equal(phased.phases.order, ref.order)
    buf = _rounds_buffer(gpu, rng, n, rows, row_bytes)
    want = rs.permute_rounds_ref(buf.clone(), moves.to(gpu))
    before = (rs.rounds_launches, rs.subrounds, rs.phases)
    got = rs.permute_rounds(buf.clone(), phased.to(gpu))
    torch.cuda.synchronize()
    assert (rs.rounds_launches - before[0], rs.subrounds - before[1],
            rs.phases - before[2]) == (1, count, ref.count)
    assert torch.equal(got, want)


def _cell_topology(cell):
    import json
    from pathlib import Path

    from repro_torch.core import topology as T
    path = Path(__file__).resolve().parents[1] / "bcastbench" / "configs"
    b = json.loads((path / f"{cell}.json").read_text())["build"]
    return getattr(T, b["fn"])(*b.get("args", ()), **b.get("kwargs", {}))


@pytest.mark.parametrize("cell", ["mesh2d-256", "dragonfly-256",
                                  "butterfly-256"])
def test_rounds_kernel_by_phase_on_the_cells_plans(gpu, cell):
    """The three cells' 256-node plans at 4e6 B from roots 0 and 17: K1 by
    phase at the in-place placement's byte offsets bit-identical to
    ``permute_rounds_ref`` in sub-round order on a random allocation, in
    fewer phases than sub-rounds, the library's phase table (its phases
    fitted to the plan's rows) equal to its plain version; and a request
    delivers the payload to every device."""
    import dataclasses

    from repro_torch import api
    from repro_torch.device import round_step as rs

    model = api.compile(_cell_topology(cell))
    for root in (0, 17):
        ex = model.executable(root=root, nbytes=4e6)
        moves = ex.moves()
        ref = rs.phase_table_ref(dataclasses.replace(moves, phases=None),
                                 rs.phase_cap(ex.lowered.row_bytes))
        assert moves.phases.offs.tolist() == ref.offs.tolist()
        assert torch.equal(moves.phases.order, ref.order)
        assert moves.phases.count < moves.num_subrounds
        x = ex.default_payload(seed=root)
        plc = ex.lowered.placement(x)
        assert plc.inplace
        g = torch.Generator(device=gpu).manual_seed(root)
        alloc = torch.randint(0, 256, (plc.alloc_bytes,), dtype=torch.uint8,
                              device=gpu, generator=g)
        want = rs.permute_rounds_ref(alloc.clone(), moves, at=plc.at)
        before = (rs.subrounds, rs.phases)
        rs.permute_rounds(alloc, moves, at=plc.at)
        torch.cuda.synchronize()
        assert (rs.subrounds - before[0], rs.phases - before[1]) == (
            moves.num_subrounds, plc.at.num_phases)
        assert torch.equal(alloc, want)
        del alloc, want
        assert ex.verify(x).ok
        torch.cuda.empty_cache()


@pytest.mark.parametrize("stale", ["a5", "answer"])
def test_inplace_broadcast_on_a_stale_block(gpu, stale):
    """The caching allocator hands a request the block the last answer of
    its shape held: filled with 0xA5, or holding that answer (another
    payload's) with its scratch. The in-place broadcast still delivers
    every byte, counts one ``runner.inplace_runs`` a request, and returns
    a contiguous ``(n,) + x.shape`` tensor in ``x``'s dtype."""
    from repro_torch import api
    from repro_torch.core import topology as T
    from repro_torch.device import runner

    for topo, root, nbytes in ((T.butterfly(32), 7, 1_000_000),
                               (T.mesh2d(4, 4), 5, 1 << 20)):
        ex = api.compile(topo).executable(root=root, nbytes=nbytes)
        ex.moves()                   # with its own payload's placement
        assert [p.inplace for p in ex.lowered.placements.values()] == [True]
        n = topo.num_nodes
        x1, x2 = ex.default_payload(seed=1), ex.default_payload(seed=2)
        before = (runner.inplace_runs, runner.staged_runs)
        first = ex.run(x1)
        torch.cuda.synchronize()
        assert (runner.inplace_runs - before[0],
                runner.staged_runs - before[1]) == (1, 0)
        ptr = first.untyped_storage().data_ptr()
        if stale == "a5":
            _storage_bytes(first).fill_(0xA5)
        del first
        out = ex.run(x2)
        torch.cuda.synchronize()
        assert out.untyped_storage().data_ptr() == ptr   # the stale block
        assert runner.inplace_runs - before[0] == 2
        assert out.shape == (n,) + tuple(x2.shape) and out.dtype == x2.dtype
        assert out.is_contiguous() and len(ex.lowered.placements) == 1
        want = x2.to(gpu).view(torch.uint8)
        got = out.view(torch.uint8).reshape(n, -1)
        assert all(torch.equal(got[v], want) for v in range(n))


def test_unpack_tail_matches_plain(gpu):
    """``unpack_tail`` (one ``unpack_rows`` launch at a pitch and offset)
    byte-equal to ``tail_ref`` on a random allocation, writing each
    device's tail and no other byte; ``unpack_bytes`` grows by 2 x n x
    tail."""
    from repro_torch.device import runner

    lay = runner.PacketLayout(n=256, total=40, relay=33, plen=4003,
                              used=16012, row_bytes=16016)
    plc = runner.Placement(lay, 39 * 16016 + 4000)
    assert (plc.full, plc.scratch, plc.tail) == (39, 34, 4000)
    g = torch.Generator(device=gpu).manual_seed(12)
    alloc = torch.randint(0, 256, (plc.alloc_bytes,), dtype=torch.uint8,
                          device=gpu, generator=g)
    want = alloc.clone()
    runner.tail_ref(want, plc)
    before = (runner.unpack_launches, runner.unpack_bytes)
    runner.unpack_tail(alloc, plc)
    torch.cuda.synchronize()
    assert (runner.unpack_launches - before[0],
            runner.unpack_bytes - before[1]) == (1, 2 * 256 * 4000)
    assert torch.equal(alloc, want)


@pytest.mark.parametrize("root,nbytes,shift", [(7, 39 * 16016 + 4000, 0),
                                               (0, 39 * 16016, 0),
                                               (255, 39 * 16016 + 4000, 8)])
def test_fill_inplace_matches_plain(gpu, root, nbytes, shift):
    """``fill_inplace`` (one launch) byte-equal to ``fill_ref`` on a random
    allocation: the root's output, its straddling row's tail (none when no
    row straddles), scratch zero, every other byte as it was; a payload off
    the 16-byte grid (``shift``) is copied to one on it first."""
    from repro_torch.device import runner

    lay = runner.PacketLayout(n=256, total=40, relay=33, plen=4003,
                              used=16012, row_bytes=16016)
    plc = runner.Placement(lay, nbytes)
    g = torch.Generator(device=gpu).manual_seed(13)
    alloc = torch.randint(0, 256, (plc.alloc_bytes,), dtype=torch.uint8,
                          device=gpu, generator=g)
    base = torch.randint(0, 256, (nbytes + 16,), dtype=torch.uint8,
                         device=gpu, generator=g)
    x = base[shift:shift + nbytes]
    want = alloc.clone()
    runner.fill_ref(want, x, plc, root)
    before = runner.fill_launches
    runner.fill_inplace(alloc, x, plc, root)
    torch.cuda.synchronize()
    assert runner.fill_launches == before + 1
    assert torch.equal(alloc, want)
    with pytest.raises(ValueError):          # an allocation of other size
        runner.fill_inplace(alloc[16:], x, plc, root)
    assert runner.fill_launches == before + 1


def test_measure_times_the_layout_run_takes(gpu, monkeypatch):
    """``ExecutablePlan.measure`` starts in place where ``run`` does, so it
    times the main path's K1 on the in-place offsets."""
    from repro_torch import api
    from repro_torch.core import topology as T
    from repro_torch.device import runner

    ex = api.compile(T.mesh2d(4, 4)).executable(root=5, nbytes=1 << 20)
    calls = []
    real = runner._launch_fill
    monkeypatch.setattr(runner, "_launch_fill",
                        lambda *a: calls.append(1) or real(*a))
    assert ex.measure(reps=2) > 0
    assert len(calls) == 3
    assert [p.inplace for p in ex.lowered.placements.values()] == [True]


def _unpack_case(gpu, lay, seed):
    g = torch.Generator(device=gpu).manual_seed(seed)
    return torch.randint(0, 256, (lay.n, lay.rows, lay.row_bytes),
                         dtype=torch.uint8, device=gpu, generator=g)


def _unpack_holds(buf, lay, x):
    """``unpack`` on the card against ``unpack_ref``: one launch, its bytes
    counted, every byte equal, a fresh contiguous tensor in x's dtype."""
    from repro_torch.device import runner

    nbytes = x.numel() * x.element_size()
    before = (runner.unpack_launches, runner.unpack_bytes)
    got = runner.unpack(buf, lay, x)
    want = runner.unpack_ref(buf, lay, nbytes)
    torch.cuda.synchronize()
    assert (runner.unpack_launches - before[0],
            runner.unpack_bytes - before[1]) == (1, 2 * lay.n * nbytes)
    assert got.dtype == x.dtype and got.shape == (lay.n,) + tuple(x.shape)
    assert got.is_contiguous() and got.device == buf.device
    assert got.untyped_storage().data_ptr() != \
        buf.untyped_storage().data_ptr()
    assert torch.equal(got.reshape(lay.n, -1).view(torch.uint8), want)


@pytest.mark.parametrize("case", LAYOUTS, ids=layout_id)
def test_unpack_kernel_matches_plain(gpu, case):
    """``unpack_rows`` byte-equal to ``unpack_ref`` on random buffers
    (padding and relay rows random too) in every dtype and alignment."""
    dtype, numel = case[0], case[5]
    lay, _ = layout(*case)
    x = torch.empty(numel, dtype=getattr(torch, dtype), device=gpu)
    _unpack_holds(_unpack_case(gpu, lay, numel), lay, x)


@pytest.mark.parametrize("total,used,row_bytes,nbytes", REAL)
def test_unpack_kernel_on_the_cells_shapes(gpu, total, used, row_bytes,
                                           nbytes):
    """The cells' layouts at their full payloads, on two devices."""
    from repro_torch.device.runner import PacketLayout

    lay = PacketLayout(n=2, total=total, relay=0, plen=used // 4, used=used,
                       row_bytes=row_bytes)
    x = torch.empty(nbytes // 4, dtype=torch.float32, device=gpu)
    _unpack_holds(_unpack_case(gpu, lay, total), lay, x)


def test_unpack_kernel_past_2_31_bytes(gpu):
    """An output and a buffer over 2**31 bytes, rows of used % 16 = 4 and a
    remainder: 64-bit offsets; the last device's last bytes equal too."""
    from repro_torch.device import runner
    from repro_torch.device.runner import PacketLayout

    n, plen, nbytes = 5, 10001, 480_000_004
    used = 4 * plen
    lay = PacketLayout(n=n, total=-(-nbytes // used), relay=0, plen=plen,
                       used=used, row_bytes=-(-used // 16) * 16)
    assert n * nbytes > 2 ** 31 and lay.buffer_bytes > 2 ** 31
    buf = _unpack_case(gpu, lay, 11)
    x = torch.empty(nbytes // 4, dtype=torch.float32, device=gpu)
    got = runner.unpack(buf, lay, x).view(torch.uint8).reshape(n, -1)
    full, rem = divmod(nbytes, used)
    torch.cuda.synchronize()
    assert torch.equal(got[n - 1, -rem:], buf[n - 1, full, :rem])
    assert torch.equal(got[n - 1, full * used - used:full * used],
                       buf[n - 1, full - 1, :used])
    assert torch.equal(got, runner.unpack_ref(buf, lay, nbytes))


def test_broadcast_unpacks_in_one_launch(gpu):
    """``ExecutablePlan.run`` on the card of a payload whose size is no
    multiple of 16 (so staged): one ``unpack_rows`` launch of 2 x n x
    nbytes bytes a broadcast, and ``verify`` holds."""
    from repro_torch import api
    from repro_torch.core import topology as T
    from repro_torch.device import runner

    model = api.compile(T.mesh2d(4, 4))
    ex = model.executable(root=5, nbytes=400_004)
    x = ex.default_payload(seed=4)
    before = (runner.unpack_launches, runner.unpack_bytes,
              runner.staged_runs)
    out = ex.run(x)
    torch.cuda.synchronize()
    assert (runner.unpack_launches - before[0],
            runner.unpack_bytes - before[1],
            runner.staged_runs - before[2]) == (1, 2 * 16 * 400_004, 1)
    xb = x.to(gpu).view(torch.uint8)
    assert all(torch.equal(out[v].view(torch.uint8), xb) for v in range(16))
    assert ex.verify(x).ok


def test_unpack_kernel_rejects_bad_inputs(gpu):
    from repro_torch.device import runner
    from repro_torch.device.runner import PacketLayout

    lay = PacketLayout(n=4, total=5, relay=0, plen=1001, used=4004,
                       row_bytes=4016)
    nbytes = 4 * 4004 + 12
    buf = torch.zeros((4, 6, 4016), dtype=torch.uint8, device=gpu)
    before = runner.unpack_launches
    with pytest.raises(ValueError):          # not contiguous
        runner.unpack_rows(buf[:, 1:], lay, nbytes)
    with pytest.raises(ValueError):          # on the CPU
        runner.unpack_rows(buf[:, 1:].cpu(), lay, nbytes)
    with pytest.raises(ValueError):          # a row of 20 bytes
        runner.unpack_rows(
            torch.zeros((4, 5, 20), dtype=torch.uint8, device=gpu),
            PacketLayout(n=4, total=5, relay=0, plen=5, used=20,
                         row_bytes=20), 80)
    flat = torch.zeros(4 * 5 * 4016 + 1, dtype=torch.uint8, device=gpu)
    with pytest.raises(ValueError):          # an address off the 16 B grid
        runner.unpack_rows(flat[1:].view(4, 5, 4016), lay, nbytes)
    assert runner.unpack_launches == before


@pytest.mark.parametrize("n,nbytes", [(8, 8 << 10), (8, 1 << 20),
                                      (256, 1 << 10), (256, 1 << 20)])
def test_ring_ladder_matches_plain(gpu, n, nbytes):
    """The calibration's ring rounds (``calibrate.ring_round``): 32
    sub-rounds in one ``permute_rounds`` launch, bit-identical to the plain
    version, each device's row 1 its predecessor's row 0; ``measure_round``
    times them in positive, finite seconds."""
    import importlib

    from repro_torch.device import round_step as rs
    C = importlib.import_module("repro_torch.device.calibrate")

    buf, moves = C.ring_round(n, nbytes, gpu, iters=32)
    want = rs.permute_rounds_ref(buf.clone(), moves, 0, 32)
    before = (rs.rounds_launches, rs.subrounds)
    rs.permute_rounds(buf, moves, 0, 32)
    torch.cuda.synchronize()
    assert (rs.rounds_launches, rs.subrounds) == (before[0] + 1,
                                                  before[1] + 32)
    assert torch.equal(buf, want) and C.ring_delivered(buf)
    t = C.measure_round(n, nbytes, device=gpu, iters=8, reps=2)
    assert np.isfinite(t) and t > 0


def test_executable_calibrate_on_card(gpu, tmp_path):
    """``ex.calibrate()`` on ring 8 through a served, stored model: the fit
    is finite with alpha >= 0 and beta > 0, the meta names the card, the
    report's times are finite, and the artifact reloads equal."""
    from repro_torch import api
    from repro_torch.core import topology as T
    from repro_torch.core.planstore import CalibrationKey, PlanStore
    from repro_torch.device import prediction_report

    store = PlanStore(str(tmp_path))
    model = api.compile(T.ring(8), server=True, store=store)
    ex = model.executable(root=0, nbytes=1 << 20)
    assert ex.verify(ex.default_payload()).ok
    cost = ex.calibrate(sizes=(8 << 10, 64 << 10, 256 << 10), iters=8,
                        reps=2)
    (a, b), = cost.classes.values()
    assert a >= 0 and b > 0 and np.isfinite([a, b]).all()
    assert cost.meta["backend"] == "cuda" and cost.meta["num_devices"] == 8
    assert cost.meta["device_name"] == torch.cuda.get_device_name(gpu)
    row, = prediction_report([ex], cost, reps=2)
    assert np.isfinite([row.predicted_cycle_s, row.measured_cycle_s,
                        row.rel_err]).all() and row.measured_cycle_s > 0
    key = CalibrationKey.for_topology(model.topo, "cuda", 8)
    store.store_calibration(key, cost)
    back, _ = store.load_calibration(key)
    assert back == cost


def _group_calibrate_rank(rank, world, store, out):
    """One NCCL rank of ``test_group_calibrate_across_gpus``."""
    import importlib
    import json

    import torch.distributed as dist

    from repro_torch import api
    from repro_torch.core import topology as T
    from repro_torch.core.simconfig import DeviceConfig, SimConfig
    from repro_torch.device import round_step as rs
    C = importlib.import_module("repro_torch.device.calibrate")

    dist.init_process_group("nccl", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        group = dist.group.WORLD
        before = rs.launches
        cost = C.calibrate(T.ring(world), group=group,
                           sizes=(8 << 10, 64 << 10), iters=8, reps=2)
        launches = rs.launches - before
        ex = api.compile(T.ring(world)).executable(
            root=0, nbytes=1 << 20,
            config=SimConfig(device=DeviceConfig(device="cuda")))
        chk = ex.verify(ex.default_payload(), group=group)
        row, = C.prediction_report([ex], cost, reps=2, group=group)
        res = dict(cost=cost.to_dict(), launches=launches, ok=chk.ok,
                   measured=row.measured_cycle_s,
                   predicted=row.predicted_cycle_s,
                   want=C.predict_cycle_time(ex, cost))
    finally:
        dist.destroy_process_group()
    with open(f"{out}.{rank}.json", "w") as f:
        json.dump(res, f)


def test_group_calibrate_across_gpus(gpu, tmp_path):
    """``calibrate`` and ``prediction_report`` with an NCCL group of up to
    four GPUs, one rank each: one cost on every rank, ``cuda-nccl`` and not
    emulated, each rank's card named, one ``permute_step`` launch a ring
    sub-round, the broadcast verified on every rank and its measured cycle
    one finite positive time on all. Skips below two GPUs."""
    import json
    import multiprocessing as mp

    from repro_torch.device.calibrate import CalibratedCost

    world = min(4, torch.cuda.device_count())
    if world < 2:
        pytest.skip("needs two GPUs or more: NCCL puts no two ranks on one")
    ctx = mp.get_context("spawn")
    out = str(tmp_path / "rank")
    procs = [ctx.Process(target=_group_calibrate_rank,
                         args=(r, world, str(tmp_path / "store"), out))
             for r in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(300)
    alive = [p.pid for p in procs if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
    assert not alive and [p.exitcode for p in procs] == [0] * world
    ranks = []
    for r in range(world):
        with open(f"{out}.{r}.json") as f:
            ranks.append(json.load(f))
    costs = [CalibratedCost.from_dict(rk["cost"]) for rk in ranks]
    assert all(c == costs[0] for c in costs)
    meta = costs[0].meta
    assert (meta["backend"], meta["emulated"], meta["num_devices"]) == \
        ("cuda-nccl", False, world)
    assert meta["device_name"] == [torch.cuda.get_device_name(i)
                                   for i in range(world)]
    (a, b), = costs[0].classes.values()
    assert a >= 0 and b > 0 and np.isfinite([a, b]).all()
    assert meta["beta_clamped"] is (b == 1.0 / 1e-18)
    assert all(rk["launches"] == 2 * 3 * 8 and rk["ok"] for rk in ranks)
    assert len({rk["measured"] for rk in ranks}) == 1
    assert 0 < ranks[0]["measured"] < float("inf")
    assert ranks[0]["predicted"] == ranks[0]["want"] > 0


@pytest.mark.parametrize("what", ["ring", "bbs", "binomial", "pipeline"])
def test_kernel_matches_plain_at_group_shapes(gpu, what):
    """``permute_step`` against its plain version at the distributed
    executor's shapes: one rank's ``[1, rows + 1, row]`` buffer, random,
    with K1's table of each write (``distributed.local_writes``), the
    staging row refilled with random bytes before each write as a receive
    refills it; the calibration ring at 8 KiB and 1 MiB, and every rank of
    a 1 MiB ring-4 broadcast. Bit-exact on the whole buffer after every
    write."""
    from repro_torch import api
    from repro_torch.core import topology as T
    from repro_torch.core.simconfig import DeviceConfig, SimConfig
    from repro_torch.device import distributed as D
    from repro_torch.device import round_step as rs
    from repro_torch.device import runner
    from repro_torch.device.calibrate import ring_row_bytes

    if what == "ring":
        cases = [(2, ring_row_bytes(s), D.ring_tables(1, 4, 8)[0])
                 for s in (8 << 10, 1 << 20)]
    else:
        ex = api.compile(T.ring(4)).executable(
            root=0, nbytes=1 << 20, algo=what,
            config=SimConfig(device=DeviceConfig(device="cpu")))
        lay = runner.packet_layout(ex.default_payload(), ex.schedule,
                                   ex.num_groups)
        cases = [(lay.rows, lay.row_bytes,
                  D.bbs_tables(ex.schedule, ex.num_groups, me)[0])
                 for me in range(4)]
    g = torch.Generator(device="cuda").manual_seed(5)
    writes = 0
    for rows, row_bytes, tabs in cases:
        local = D.local_writes(tabs, rows)
        tab = torch.from_numpy(local).cuda()
        got = torch.randint(0, 256, (1, rows + 1, row_bytes),
                            dtype=torch.uint8, device="cuda", generator=g)
        ref = got.clone()
        for k in np.flatnonzero(local[:, 4, 0]):
            fresh = torch.randint(0, 256, (row_bytes,), dtype=torch.uint8,
                                  device="cuda", generator=g)
            got[0, rows] = fresh
            ref[0, rows] = fresh
            rs.permute_step_ref(ref, tab[k])
            rs.permute_step(got, tab[k])
            assert torch.equal(got, ref), (rows, row_bytes, k)
            writes += 1
    assert writes > 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_gradients_are_the_plain_versions_on_card(gpu, dtype):
    """With an input that requires grad, K2 and K3 launch once each (the
    forward, counted) and their input gradients are bit-equal to autograd
    through the plain versions on the same inputs; under ``no_grad`` the
    same calls launch too, with no ``grad_fn``."""
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssd_scan as K

    dt_ = getattr(torch, dtype)
    cases = [(FA.flash_attention,
              lambda *a, c=causal: ref.attention_ref(*a, causal=c),
              _attn_inputs(gpu, 3, 2, 4, 2, s, t, 64, dt_), dict(causal=causal))
             for causal, s, t in ((True, 64, 64), (False, 16, 48),
                                  (True, 20, 52))]
    cases.append((K.ssd_scan, lambda *a: ref.ssd_chunked(*a, chunk=32),
                  _ssd_inputs(gpu, 3, 1, 100, 2, 32, 16, dt_), dict(chunk=32)))
    for fn, plain, inputs, kw in cases:
        g = torch.Generator(device=gpu).manual_seed(1)
        leaves = [t.clone().requires_grad_() for t in inputs]
        before = (FA.launches, K.launches)
        out = fn(*leaves, **kw)
        launched = (FA.launches - before[0]) + (K.launches - before[1])
        assert launched == 1 and out.grad_fn is not None
        up = torch.randn(out.shape, device=gpu, generator=g).to(out.dtype)
        got = torch.autograd.grad(out, leaves, up)
        twins = [t.clone().requires_grad_() for t in inputs]
        want = torch.autograd.grad(plain(*twins), twins, up)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and torch.isfinite(a.float()).all()
            assert torch.equal(a, b)
        with torch.no_grad():
            assert fn(*leaves, **kw).grad_fn is None
        assert (FA.launches - before[0]) + (K.launches - before[1]) == 2


SSD_SHAPES = [(1, 64, 2, 32, 16, 32), (2, 100, 4, 64, 32, 32),
              (1, 256, 2, 64, 128, 128), (1, 32, 8, 128, 64, 16),
              (2, 5, 3, 64, 128, 128), (2, 37, 3, 64, 128, 128),
              (2, 300, 3, 128, 64, 37), (1, 100, 2, 32, 16, 8),
              # zamba2-7b's 56 heads of 128 with state 64 (ssd_tc<128, 64>)
              (2, 256, 56, 128, 64, 128)]


def _ssd_inputs(gpu, seed, b, s, h, dh, ds, dtype):
    g = torch.Generator(device=gpu).manual_seed(seed)
    x = torch.randn(b, s, h, dh, device=gpu, generator=g).to(dtype)
    dt = torch.nn.functional.softplus(
        torch.randn(b, s, h, device=gpu, generator=g)) * 0.1
    A = -torch.exp(torch.randn(h, device=gpu, generator=g))
    B = torch.randn(b, s, h, ds, device=gpu, generator=g).to(dtype)
    C = torch.randn(b, s, h, ds, device=gpu, generator=g).to(dtype)
    return x, dt, A, B, C


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,h,dh,ds,chunk", SSD_SHAPES)
def test_ssd_kernel_matches_plain(gpu, dtype, b, s, h, dh, ds, chunk):
    """K3 against ``ssd_chunked`` on the card; tolerances of
    ``tests/test_kernels.py`` (float32 3e-5, bf16 2e-2)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssd_scan as K

    args = _ssd_inputs(gpu, s, b, s, h, dh, ds, getattr(torch, dtype))
    before = K.launches
    got = K.ssd_scan(*args, chunk=chunk)
    torch.cuda.synchronize()
    assert K.launches == before + 1 and got.dtype == args[0].dtype
    want = ref.ssd_chunked(*args, chunk=chunk)
    tol = 2e-2 if dtype == "bfloat16" else 3e-5
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4),
                                       ("bfloat16", 2e-2)])
def test_ssd_kernel_chunk_invariance(gpu, dtype, tol):
    """Chunks of 32, 64 and 128 against chunk 16: float32 within 1e-4;
    bf16 within its gate of 2e-2 (the output's own rounding to bf16 differs
    by an ulp between chunkings)."""
    from repro_torch.kernels import ssd_scan as K

    args = _ssd_inputs(gpu, 1, 1, 128, 2, 32, 16, getattr(torch, dtype))
    outs = [K.ssd_scan(*args, chunk=c) for c in (16, 32, 64, 128)]
    for o in outs[1:]:
        torch.testing.assert_close(o.float(), outs[0].float(), atol=tol,
                                   rtol=tol)


def test_ssd_kernel_many_waves_and_deterministic(gpu):
    """4 x 4096 steps x 32 heads in bf16: 4,096 (batch, head, chunk) items,
    many waves of blocks handing the state on; against ``ssd_chunked`` at
    2e-2, and two launches bit-identical (no atomics in any sum)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssd_scan as K

    args = _ssd_inputs(gpu, 7, 4, 4096, 32, 64, 128, torch.bfloat16)
    got = K.ssd_scan(*args)
    again = K.ssd_scan(*args)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int16), again.view(torch.int16))
    torch.testing.assert_close(got.float(), ref.ssd_chunked(*args).float(),
                               atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("dh,ds,seq,chunk", [(16, 64, 64, 64),
                                             (64, 256, 64, 64),
                                             (64, 128, 512, 256),
                                             (48, 64, 64, 64)])
def test_ssd_kernel_bf16_shape_outside_raises(gpu, dh, ds, seq, chunk):
    """A bf16 shape the tensor-core kernel does not take raises; it never
    falls to the float32 kernel or the plain version."""
    from repro_torch.kernels import ssd_scan as K

    args = _ssd_inputs(gpu, 8, 1, seq, 2, dh, ds, torch.bfloat16)
    before = K.launches
    with pytest.raises(ValueError, match="bfloat16 kernel takes"):
        K.ssd_scan(*args, chunk=chunk)
    assert K.launches == before


@pytest.mark.parametrize("bf16", [1, 0])
def test_ssd_kernel_fits_the_prefill_shape(gpu, bf16):
    """Mamba-2 370M prefill (chunk 128, dh 64, ds 128) fits one block's
    shared memory in bf16 (the model's dtype) and in float32."""
    from repro_torch.kernels import ssd_scan as K

    lib = K._kernel()
    assert 0 < lib.ssd_scan_smem(128, 64, 128, bf16) <= \
        lib.ssd_scan_smem_limit()


def test_ssd_kernel_rejects_bad_inputs(gpu):
    from repro_torch.kernels import ssd_scan as K

    x, dt, A, B, C = _ssd_inputs(gpu, 2, 1, 64, 2, 32, 16, torch.bfloat16)
    with pytest.raises(ValueError):              # mixed dtypes
        K.ssd_scan(x, dt, A, B.float(), C)
    with pytest.raises(ValueError):              # not contiguous
        K.ssd_scan(x.transpose(2, 3).contiguous().transpose(2, 3), dt, A,
                   B, C)
    with pytest.raises(ValueError):              # A on the CPU
        K.ssd_scan(x, dt, A.cpu(), B, C)
    big = _ssd_inputs(gpu, 3, 1, 256, 1, 128, 128, torch.float32)
    with pytest.raises(ValueError):              # shared memory too large
        K.ssd_scan(*big, chunk=128)


def test_lm_on_card_matches_cpu(gpu):
    """The smoke Mamba-2 in float32: one K3 launch per layer in forward, and
    forward and decode logits equal to the CPU run (1e-4)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ssd_scan as K
    from repro_torch.models.model import LM

    cfg = get_config("mamba2-370m").smoke().scaled(dtype="float32")
    cpu, card = LM(cfg, device="cpu"), LM(cfg, device=gpu)
    card.load_state_dict(cpu.state_dict())
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 40)).astype(np.int32))
    before = K.launches
    got = card.forward(dict(tokens=toks))
    assert K.launches - before == cfg.layers
    torch.testing.assert_close(got.cpu(), cpu.forward(dict(tokens=toks)),
                               atol=1e-4, rtol=1e-4)
    c_cpu, c_card = cpu.init_cache(2, 4), card.init_cache(2, 4)
    for t in range(4):
        a = cpu.decode_step(c_cpu, toks[:, t:t + 1])[0]
        b = card.decode_step(c_card, toks[:, t:t + 1])[0]
        torch.testing.assert_close(b.cpu(), a, atol=1e-4, rtol=1e-4)


# tests/test_kernels.py:20-29, plus the smoke configs' head dim 16 and S > T;
# then shapes that cross the bf16 kernel's 128-row and 128-key tiles: ragged
# S = T at every head dim, the decode offset against T = 2048, and S > T,
# where with S - T >= 128 a whole tile of 128 query rows sees no key
ATTN_SHAPES = [(1, 4, 4, 128, 128, 64), (2, 8, 2, 128, 128, 64),
               (1, 8, 8, 64, 64, 128), (1, 4, 1, 96, 96, 64),
               (1, 8, 4, 1, 256, 64), (2, 4, 4, 37, 37, 32),
               (2, 4, 2, 70, 70, 16), (1, 4, 2, 100, 60, 64),
               (1, 4, 2, 300, 300, 128), (1, 4, 2, 1000, 1000, 128),
               (1, 4, 2, 300, 300, 64), (1, 4, 2, 1000, 1000, 64),
               (1, 4, 2, 300, 300, 32), (1, 4, 2, 300, 300, 16),
               (2, 4, 2, 1, 2048, 128), (2, 4, 2, 16, 2048, 128),
               (2, 4, 2, 300, 200, 128), (2, 4, 2, 300, 100, 128),
               (2, 4, 2, 300, 100, 64),
               # head dim 112 (zamba2-7b): the bf16 kernel's zero-filled
               # route on the D 128 tile, and the float32 instance; last
               # zamba2-7b's prefill shape
               (1, 4, 2, 96, 96, 112), (1, 4, 2, 1000, 1000, 112),
               (2, 4, 2, 16, 2048, 112), (2, 4, 2, 300, 100, 112),
               (4, 32, 32, 2048, 2048, 112)]


def _attn_inputs(gpu, seed, b, hq, hkv, s, t, d, dtype):
    g = torch.Generator(device=gpu).manual_seed(seed)
    return tuple(torch.randn(shape, device=gpu, generator=g).to(dtype)
                 for shape in ((b, hq, s, d), (b, hkv, t, d), (b, hkv, t, d)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("b,hq,hkv,s,t,d", ATTN_SHAPES)
def test_attention_kernel_matches_plain(gpu, dtype, causal, b, hq, hkv, s, t,
                                        d):
    """K2 against ``attention_ref`` on the card; tolerances of
    ``tests/test_kernels.py`` (float32 3e-5, bf16 2e-2); fully-masked rows
    (causal, S > T) exactly 0."""
    from repro_torch.kernels import flash_attention as K
    from repro_torch.kernels import ref

    args = _attn_inputs(gpu, s + t + d, b, hq, hkv, s, t, d,
                        getattr(torch, dtype))
    before = K.launches
    got = K.flash_attention(*args, causal=causal)
    torch.cuda.synchronize()
    assert K.launches == before + 1 and got.dtype == args[0].dtype
    want = ref.attention_ref(*args, causal=causal)
    tol = 2e-2 if dtype == "bfloat16" else 3e-5
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
    if causal and s > t:
        assert not got[:, :, :s - t].any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s", [1, 2048])
def test_attention_kernel_encdec_cross_attention(gpu, dtype, s):
    """seamless-m4t-large-v2's cross-attention: 16 q and 16 kv heads of 64,
    non-causal, S = 2048 (a prefill, and its encoder) and S = 1 (decode)
    against the encoder's T = 2048."""
    from repro_torch.kernels import flash_attention as K
    from repro_torch.kernels import ref

    args = _attn_inputs(gpu, 7 + s, 2, 16, 16, s, 2048, 64,
                        getattr(torch, dtype))
    before = K.launches
    got = K.flash_attention(*args, causal=False)
    torch.cuda.synchronize()
    assert K.launches == before + 1
    want = ref.attention_ref(*args, causal=False)
    tol = 2e-2 if dtype == "bfloat16" else 3e-5
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


def test_attention_kernel_reads_model_layout_by_strides(gpu):
    """q, k, v as (B, H, S, D) views of (B, S, H, D) projections: no copy,
    and the output has q's strides."""
    from repro_torch.kernels import flash_attention as K
    from repro_torch.kernels import ref

    g = torch.Generator(device=gpu).manual_seed(9)
    x = torch.randn(2, 50, 8, 32, device=gpu, generator=g)
    kv = torch.randn(2, 2, 50, 4, 32, device=gpu, generator=g)
    q, k, v = x.transpose(1, 2), kv[0].transpose(1, 2), kv[1].transpose(1, 2)
    got = K.flash_attention(q, k, v)
    assert got.stride() == q.stride()
    torch.testing.assert_close(got, ref.attention_ref(q, k, v), atol=3e-5,
                               rtol=3e-5)


def test_attention_kernel_reads_model_layout_by_strides_bf16(gpu):
    """The bf16 kernel's TMA maps over the (B, H, S, D) views of (B, S, H,
    D) projections, across its 128-row and 128-key tiles: no copy, q's
    strides on the output."""
    from repro_torch.kernels import flash_attention as K
    from repro_torch.kernels import ref

    g = torch.Generator(device=gpu).manual_seed(10)
    x = torch.randn(2, 300, 8, 128, device=gpu, generator=g).bfloat16()
    kv = torch.randn(2, 2, 300, 4, 128, device=gpu, generator=g).bfloat16()
    q, k, v = x.transpose(1, 2), kv[0].transpose(1, 2), kv[1].transpose(1, 2)
    got = K.flash_attention(q, k, v)
    assert got.stride() == q.stride()
    torch.testing.assert_close(got.float(),
                               ref.attention_ref(q, k, v).float(),
                               atol=2e-2, rtol=2e-2)


def test_attention_kernel_reads_model_layout_by_strides_d112(gpu):
    """Head dim 112 in bf16 over (B, H, S, D) views of (B, S, H, D)
    projections: 224-byte rows, the tensor maps' inner dimension 112; the
    output's columns are exactly those of the plain version's shape, q's
    strides."""
    from repro_torch.kernels import flash_attention as K
    from repro_torch.kernels import ref

    g = torch.Generator(device=gpu).manual_seed(12)
    x = torch.randn(2, 300, 8, 112, device=gpu, generator=g).bfloat16()
    kv = torch.randn(2, 2, 300, 4, 112, device=gpu, generator=g).bfloat16()
    q, k, v = x.transpose(1, 2), kv[0].transpose(1, 2), kv[1].transpose(1, 2)
    got = K.flash_attention(q, k, v)
    assert got.stride() == q.stride() and got.shape[-1] == 112
    torch.testing.assert_close(got.float(),
                               ref.attention_ref(q, k, v).float(),
                               atol=2e-2, rtol=2e-2)


def test_attention_kernel_rejects_bad_inputs(gpu):
    from repro_torch.kernels.flash_attention import flash_attention

    q, k, v = _attn_inputs(gpu, 1, 1, 4, 2, 16, 16, 64, torch.float32)
    with pytest.raises(ValueError):              # float16
        flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(ValueError):              # mixed dtypes
        flash_attention(q, k.bfloat16(), v)
    with pytest.raises(ValueError):              # head dim 48
        flash_attention(q[..., :48], k[..., :48], v[..., :48])
    with pytest.raises(ValueError):              # d not contiguous
        flash_attention(q.transpose(2, 3).contiguous().transpose(2, 3), k, v)
    with pytest.raises(ValueError):              # k on the CPU
        flash_attention(q, k.cpu(), v)
    with pytest.raises(ValueError):              # Hq % Hkv
        flash_attention(q[:, :3], k, v)
    qb = q.bfloat16()
    with pytest.raises(ValueError, match="16-byte"):   # row stride of 66
        flash_attention(torch.zeros((1, 4, 16, 66), dtype=torch.bfloat16,
                                    device=gpu)[..., :64],
                        k.bfloat16(), v.bfloat16())
    with pytest.raises(ValueError, match="16-byte"):   # base address + 2 B
        flash_attention(qb.flatten()[1:3841].view(1, 4, 15, 64),
                        k.bfloat16(), v.bfloat16())


def test_dense_lm_on_card_matches_cpu(gpu):
    """The smoke llama3.2-3b in float32 with the full config's TP padding:
    one K2 launch per layer in a prefill, the prefill's logits and cache and
    the decode logits equal to the CPU run (1e-4)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as K
    from repro_torch.models.model import LM

    cfg = get_config("llama3.2-3b").smoke().scaled(dtype="float32",
                                                   tp_pad=16)
    cpu, card = LM(cfg, device="cpu"), LM(cfg, device=gpu)
    card.load_state_dict(cpu.state_dict())
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 40)).astype(np.int32))
    c_cpu, c_card = cpu.init_cache(2, 44), card.init_cache(2, 44)
    before = K.launches
    got, _ = card.prefill(dict(tokens=toks), c_card)
    assert K.launches - before == cfg.layers
    want, _ = cpu.prefill(dict(tokens=toks), c_cpu)
    torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=1e-4)
    for key in ("k", "v"):
        torch.testing.assert_close(c_card[key].cpu(), c_cpu[key], atol=1e-4,
                                   rtol=1e-4)
    for t in range(4):
        a = cpu.decode_step(c_cpu, toks[:, t:t + 1])[0]
        b = card.decode_step(c_card, toks[:, t:t + 1])[0]
        torch.testing.assert_close(b.cpu(), a, atol=1e-4, rtol=1e-4)
    assert K.launches - before == cfg.layers


FAMILY_LAUNCHES = {  # arch: (K2, K3) launches of a smoke prefill
    "llava-next-mistral-7b": (2, 0), "granite-moe-1b-a400m": (2, 0),
    "arctic-480b": (2, 0), "zamba2-7b": (1, 3),
    "seamless-m4t-large-v2": (6, 0)}


@pytest.mark.parametrize("arch", sorted(FAMILY_LAUNCHES))
def test_family_lm_on_card_matches_cpu(gpu, arch):
    """Each new family's smoke LM in float32 on the card against the same
    model on the CPU: a prefill's K2 and K3 launches, its logits and cache,
    and 4 decode steps' logits (1e-4; cache states within 1e-4 of their
    largest value)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ssd_scan as K
    from repro_torch.models.model import LM

    cfg = get_config(arch).smoke().scaled(dtype="float32")
    cpu, card = LM(cfg, device="cpu"), LM(cfg, device=gpu)
    card.load_state_dict(cpu.state_dict())
    rng = np.random.default_rng(1)
    batch = dict(tokens=torch.from_numpy(rng.integers(
        0, cfg.vocab, (2, 40)).astype(np.int32)))
    if cfg.family == "vlm":
        batch["patches"] = torch.from_numpy(rng.standard_normal(
            (2, cfg.num_patches, cfg.d_model)).astype(np.float32) * 0.02)
    if cfg.family == "encdec":
        batch["frames"] = torch.from_numpy(rng.standard_normal(
            (2, 24, cfg.d_model)).astype(np.float32) * 0.02)
    n = 40 + (cfg.num_patches if cfg.family == "vlm" else 0)
    c_cpu = cpu.init_cache(2, n + 4, enc_len=24)
    c_card = card.init_cache(2, n + 4, enc_len=24)
    before = (FA.launches, K.launches)
    got, _ = card.prefill(batch, c_card)
    assert (FA.launches - before[0], K.launches - before[1]) == \
        FAMILY_LAUNCHES[arch]
    want, _ = cpu.prefill(batch, c_cpu)
    torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=1e-4)
    for key, t in c_cpu.items():
        tol = 1e-4 * max(1.0, float(t.abs().max()))
        torch.testing.assert_close(c_card[key].cpu(), t, atol=tol, rtol=tol)
    for t in range(4):
        tok = batch["tokens"][:, t:t + 1]
        a = cpu.decode_step(c_cpu, tok)[0]
        b = card.decode_step(c_card, tok)[0]
        torch.testing.assert_close(b.cpu(), a, atol=1e-4, rtol=1e-4)


EC_LISTS = [("mesh2d", (4, 6), "binomial"), ("mesh2d", (4, 6), "flat"),
            ("mesh2d", (16, 16), "srda"), ("mesh2d", (16, 16), "glf"),
            ("mesh2d", (16, 16), "bine"), ("mesh2d", (16, 16), "flat"),
            ("dragonfly", (4, 4, 2), "srda"), ("fat_tree", (4,), "bine")]


def _ec_arrays(gpu, topo_name, args, name, sizes):
    from repro_torch.core import kernelsim as KS
    from repro_torch.core import topology as T
    from repro_torch.core.intersection import ALL_PORT, FULL_DUPLEX, \
        ConflictModel

    topo = getattr(T, topo_name)(*args)
    cm = ConflictModel(topo, ALL_PORT if topo_name == "dragonfly"
                       else FULL_DUPLEX)
    ctl, durs, nbytes = KS.lower_baseline_lanes(topo, cm, name, 0, sizes)
    ctl.bind(cm.compiled())
    stat = [torch.from_numpy(a) for a in KS._static_arrays(ctl,
                                                           cm.compiled())]
    return topo, cm, ctl, stat, torch.from_numpy(durs), nbytes


@pytest.mark.parametrize("topo_name,args,name", EC_LISTS)
def test_event_core_kernel_matches_plain(gpu, topo_name, args, name):
    """Bit-exact against ``event_core_ref`` on the CPU, three lanes of one
    lowered list in one launch."""
    from repro_torch.core import kernelsim as KS

    _, _, _, stat, durs, _ = _ec_arrays(gpu, topo_name, args, name,
                                        [4e4, 3e6, 64e6])
    want = KS.event_core(*stat, durs)
    before = KS.launches
    got = KS.event_core(*(t.to(gpu) for t in stat), durs.to(gpu))
    torch.cuda.synchronize()
    assert KS.launches == before + 1
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g.cpu(), w)


@pytest.mark.parametrize("memory", ["shared", "global"])
@pytest.mark.parametrize("topo_name,args,name", EC_LISTS)
def test_event_core_both_variants_match_plain(gpu, topo_name, args, name,
                                              memory):
    """Each memory variant of the kernel, forced, returns what
    ``event_core_ref`` returns."""
    from repro_torch.core import kernelsim as KS

    _, _, _, stat, durs, _ = _ec_arrays(gpu, topo_name, args, name,
                                        [4e4, 64e6])
    want = KS.event_core(*stat, durs)
    dev = [t.to(gpu) for t in stat]
    st = KS.compact_structure(*dev)
    before = KS.variant_launches[memory]
    got = KS.launch(st, durs.to(gpu), memory=memory)
    torch.cuda.synchronize()
    assert KS.variant_launches[memory] == before + 1
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


def test_event_core_profile_build_matches_and_counts(gpu):
    """The kernel built with ``EC_PROFILE`` returns the kernel's results
    (``profile`` checks it) and counts one admission a task; every phase
    took cycles on a list with parks."""
    from repro_torch.core import kernelsim as KS

    _, _, _, stat, durs, _ = _ec_arrays(gpu, "mesh2d", (16, 16), "srda",
                                        [64e6])
    st = KS.compact_structure(*(t.to(gpu) for t in stat))
    prof = KS.profile(st, durs.to(gpu))
    n = stat[0].numel()
    assert prof["counts"]["admissions"] == n
    assert prof["counts"]["parks"] == prof["counts"]["wake hops"] > 0
    assert all(v > 0 for v in prof["cycles"].values())


def _wide_row(n_free=35):
    """Task 0 holds resource X; task 1's row is ``n_free`` private
    resources, then X, so its first full resource lies past lane 31 of the
    checking warp: it parks there and wakes when task 0 completes. Task 2
    depends on task 1 and shares one of its private resources."""
    nres = n_free + 1
    x = n_free
    K = n_free + 1
    res = np.full((3, K), nres, dtype=np.int32)        # nres: the dummy
    res[0, 0] = x
    res[1, :] = np.arange(K)                            # ..., then X
    res[2, 0] = 3
    caps = np.ones(nres + 1, dtype=np.int32)
    caps[nres] = 2 ** 30
    deps = np.full((3, 1), 3, dtype=np.int32)
    deps[2, 0] = 1
    rank = np.asarray([0, 1, 2], dtype=np.int32)
    durs = np.asarray([[5.0, 1.0, 2.0], [1.0, 3.0, 1.0]])
    return rank, res, caps, deps, durs


@pytest.mark.parametrize("memory", ["shared", "global"])
def test_event_core_first_busy_resource_past_lane_31(gpu, memory):
    from repro_torch.core import kernelsim as KS

    stat = [torch.from_numpy(a) for a in _wide_row()]
    want = KS.event_core(*stat)
    # task 1 waits for task 0: it starts at 5 (lane 0) and 1 (lane 1)
    assert want[0].tolist() == [[5.0, 6.0, 8.0], [1.0, 4.0, 5.0]]
    st = KS.compact_structure(*(t.to(gpu) for t in stat[:4]))
    assert st.row_ptr.tolist() == [0, 1, 37, 38]
    got = KS.launch(st, stat[4].to(gpu), memory=memory)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


def test_event_core_more_than_1024_running(gpu):
    """3,000 tasks with private resources and no dependencies all run at
    once, so the running list outgrows its shared part into the lane's
    workspace; ties in finish times are broken by sequence numbers."""
    from repro_torch.core import kernelsim as KS

    n, rng = 3000, np.random.default_rng(5)
    rank = rng.permutation(n).astype(np.int32)
    res = np.arange(n, dtype=np.int32)[:, None]
    caps = np.ones(n, dtype=np.int32)
    deps = np.full((n, 1), n, dtype=np.int32)
    durs = rng.integers(1, 4, (2, n)).astype(np.float64)
    stat = [torch.from_numpy(a) for a in (rank, res, caps, deps, durs)]
    want = KS.event_core(*stat)
    st = KS.compact_structure(*(t.to(gpu) for t in stat[:4]))
    for memory in ("shared", "global"):
        got = KS.launch(st, stat[4].to(gpu), memory=memory)
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w)


@pytest.mark.parametrize("side", [0, 1])
def test_event_core_both_sides_of_the_shared_memory_threshold(gpu, side):
    """A random list just small enough for the shared variant and one just
    too large: ``variant`` picks each, and the kernel equals
    ``event_core_ref`` (on the CPU) on both."""
    from repro_torch.core import kernelsim as KS

    lib = KS._kernel()
    limit, nres = lib.event_core_max_shared(1), 64
    n = 1024
    while lib.event_core_shared_bytes(n + 1024, nres, 1) <= limit:
        n += 1024
    while lib.event_core_shared_bytes(n + 1, nres, 1) <= limit:
        n += 1
    n += side                       # the last n that fits, and one more
    stat = [torch.from_numpy(a).to(gpu) for a in KS.random_structure(
        np.random.default_rng(n), n, 2, nres=nres, K=4, D=3)]
    st = KS.compact_structure(*stat[:4])
    assert st.caps.numel() == nres      # every resource can block
    assert KS.variant(n, nres) == ("shared", "global")[side]
    before = dict(KS.variant_launches)
    got = KS.event_core(*stat)
    assert KS.variant_launches[("shared", "global")[side]] == \
        before[("shared", "global")[side]] + 1
    want = KS.event_core_ref(*(t.cpu() for t in stat))
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


@pytest.mark.parametrize("zero_cap", [False, True])
@pytest.mark.parametrize("n,lanes", [(1, 1), (40, 3), (333, 5),
                                     (2100, 2)])
def test_event_core_kernel_random_structures(gpu, n, lanes, zero_cap):
    """Ties, repeated ids, dummy pads, one task and lists of up to 2,100;
    with ``zero_cap`` the completion step with ``min(fin)`` inf, where a
    done or unstarted task wins the scan of all n keys."""
    from repro_torch.core import kernelsim as KS

    stat = [torch.from_numpy(a) for a in KS.random_structure(
        np.random.default_rng(n), n, lanes, nres=max(2, n // 8), K=4,
        D=3, zero_cap=zero_cap)]
    want = KS.event_core(*stat)
    got = KS.event_core(*(t.to(gpu) for t in stat))
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


def test_kernelsim_on_card_matches_numpy_and_batches(gpu, monkeypatch):
    """``KernelSim`` on cuda takes the kernel by default, on lists and on a
    12-lane batch in one launch, bit-identical to ``CompiledSim``; a
    foldable list launches nothing."""
    from repro_torch.core import kernelsim as KS
    from repro_torch.core.baselines import lower_baseline
    from repro_torch.core.fastsim import CompiledSim

    monkeypatch.delenv("REPRO_KERNEL_JIT", raising=False)
    sizes = np.geomspace(1e5, 1e9, 12).tolist()
    topo, cm, ctl, _, durs, nbytes = _ec_arrays(gpu, "mesh2d", (16, 16),
                                                "srda", sizes)
    ks, nsim = KS.KernelSim(topo, cm, 0), CompiledSim(topo, cm, 0)
    before = KS.launches
    got = ks.run_lowered_batch(ctl, durs.numpy(), nbytes)
    assert KS.launches == before + 1
    for g, s in zip(got, sizes):
        r = nsim.run_lowered(lower_baseline(topo, cm, "srda", 0, s))
        assert (g.finish_time, g.deliveries, g.node_finish,
                g.group_finish) == (r.finish_time, r.deliveries,
                                    r.node_finish, r.group_finish)
    one = ks.run_lowered(lower_baseline(topo, cm, "glf", 0, 64e6))
    assert KS.launches == before + 2
    assert one.deliveries == nsim.run_lowered(
        lower_baseline(topo, cm, "glf", 0, 64e6)).deliveries
    from repro_torch.core import topology as T
    from repro_torch.core.intersection import ConflictModel
    small = T.mesh2d(4, 6)
    fold = lower_baseline(small, ConflictModel(small), "srda", 0, 64e6)
    assert fold.seg is not None and fold.seg.foldable
    KS.KernelSim(small, ConflictModel(small), 0).run_lowered(fold)
    assert KS.launches == before + 2


def test_event_core_kernel_rejects_bad_inputs(gpu):
    from repro_torch.core import kernelsim as KS

    stat = [torch.from_numpy(a).to(gpu) for a in KS.random_structure(
        np.random.default_rng(0), 10, 2)]
    with pytest.raises(ValueError):           # durs float32
        KS.event_core(*stat[:4], stat[4].float())
    with pytest.raises(ValueError):           # rank on the CPU
        KS.event_core(stat[0].cpu(), *stat[1:])


def test_event_core_runs_the_largest_sweep_list(gpu, monkeypatch):
    """mesh2d 64 x 64 srda at 64e6, the reference sweep's largest list
    (53,247 tasks; ``benchmarks/gridsweep.py``), runs on the card in one
    launch, equal to the numpy engine: no size is routed elsewhere."""
    from repro_torch.core import kernelsim as KS
    from repro_torch.core import topology as T
    from repro_torch.core.baselines import lower_baseline
    from repro_torch.core.fastsim import CompiledSim
    from repro_torch.core.intersection import ConflictModel

    monkeypatch.delenv("REPRO_KERNEL_JIT", raising=False)
    topo = T.mesh2d(64, 64)
    cm = ConflictModel(topo)
    ctl = lower_baseline(topo, cm, "srda", 0, 64e6)
    assert ctl.n == 53247 and not (ctl.seg is not None and ctl.seg.foldable)
    before, glob = KS.launches, KS.variant_launches["global"]
    got = KS.KernelSim(topo, cm, 0).run_lowered(ctl)
    assert KS.launches == before + 1
    assert KS.variant_launches["global"] == glob + 1
    want = CompiledSim(topo, cm, 0).run_lowered(ctl)
    assert (got.finish_time, got.deliveries, got.node_finish) == \
        (want.finish_time, want.deliveries, want.node_finish)


def test_cuda_tensors_never_take_the_shape_ops(gpu):
    """A CUDA tensor goes to K2 and K3 through ``ops``, never to the
    dry-run's fake-only ``attention_shape`` / ``ssd_shape``, whose
    implementation for a tensor with data raises."""
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ops
    from repro_torch.kernels import ssd_scan as K

    g = torch.Generator(device="cuda").manual_seed(0)
    q = torch.randn((1, 2, 16, 32), device="cuda", generator=g)
    k = torch.randn((1, 2, 16, 32), device="cuda", generator=g)
    before = FA.launches
    ops.attention(q, k, k)
    assert FA.launches == before + 1
    with pytest.raises(RuntimeError, match="fake and meta"):
        ops.attention_shape(q, k, k, True)
    x = torch.randn((1, 32, 2, 32), device="cuda", generator=g)
    dt = torch.rand((1, 32, 2), device="cuda", generator=g)
    bc = torch.randn((1, 32, 2, 16), device="cuda", generator=g)
    a = -torch.rand((2,), device="cuda", generator=g)
    before = K.launches
    ops.ssd(x, dt, a, bc, bc)
    assert K.launches == before + 1
    with pytest.raises(RuntimeError, match="fake and meta"):
        ops.ssd_shape(x, dt, a, bc, bc)
