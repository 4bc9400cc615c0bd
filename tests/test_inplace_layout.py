"""The runner's in-place layout against its staged layout and the reference,
on the CPU at smoke size.

In place, K1 (``round_step.permute_rounds``; on the CPU its plain version
``permute_rounds_ref``) writes every packet row that lies wholly inside the
payload straight into the stacked output, at the byte offsets
``runner.place`` makes; only the row that straddles the payload's end, rows
of padding alone and relay rows live in a zeroed scratch region after the
output. So no byte of a non-root device's output may depend on what the
allocation held before. Each case runs the runner's one composition
(``runner.broadcast`` on a ``LoweredPlan`` with K1's moves), its fresh
allocation poisoned, before the start fills it, with 0xA5 and, separately,
with another payload's answer of the same shape, and its stacked output
must be byte-identical to the staged path's (the ``[n, rows, row_bytes]``
buffer and its sub-round tables) and to the reference package's
``bbs_broadcast`` on the same schedule, run in one subprocess on a
16-device XLA-emulated host mesh, as ``tests/test_torch_slice.py`` runs
it. Tolerance: exact.

The cases cover meshes, dragonflies and butterflies; a two-tree plan with
relay rows; ``used % 16`` of 0, 4, 8 and 12; one to three packet rows past
a device's full rows; roots other than 0; a payload whose size is not a
multiple of 16 (staged); and a planted plan that reads a packet row before
writing it (staged, and wrong in place).
"""

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.device import round_step as rs
from repro_torch.device import runner

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")

# (fabric, root, nbytes, num_groups (None: the plan's), dtype), then what
# the case covers: used % 16, packet rows past the full rows, relay rows
CASES = [
    (("butterfly16", 0, 8192, None, "float32"), (8, 1, 9)),
    (("butterfly16", 5, 20000, 32, "float32"), (12, 2, 13)),
    (("butterfly16", 5, 64000, 108, "float32"), (4, 3, 0)),
    (("butterfly16", 0, 64000, 72, "float32"), (0, 2, 9)),
    (("dragonfly16", 0, 4096, None, "float32"), (0, 0, 0)),
    (("dragonfly16", 0, 64000, 64, "float32"), (4, 3, 0)),
    (("dragonfly16", 3, 20000, None, "float32"), (4, 1, 0)),
    (("mesh2d_4x4", 5, 64000, 104, "float32"), (8, 2, 0)),
    (("mesh2d_4x4", 0, 20000, None, "float32"), (12, 1, 0)),
    (("mesh2d_4x4", 3, 20000, None, "bfloat16"), (None, 1, 0)),
]
STAGED = ("mesh2d_4x4", 5, 20004, None, "float32")   # 20004 % 16 = 4
PLANTED = ("mesh2d_4x4", 5, 64000, None, "float32")
REF_CASES = [c for c, _ in CASES] + [STAGED, PLANTED]

REFERENCE = """
import dataclasses, json, sys
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh
from repro import api
from repro.core import topology as T
from repro.device.runner import bbs_broadcast

out_dir = sys.argv[1]
cases = json.load(open(out_dir + "/cases.json"))
fabrics = {"mesh2d_4x4": lambda: T.mesh2d(4, 4),
           "dragonfly16": lambda: T.dragonfly(16, nodes_per_router=2,
                                              routers_per_group=2),
           "butterfly16": lambda: T.butterfly(16)}
mesh = Mesh(np.array(jax.devices()), ("x",))
models, arrays, meta = {}, {}, []
for i, (fab, root, nbytes, groups, dt) in enumerate(cases):
    model = models.setdefault(fab, api.compile(fabrics[fab]()))
    ex = model.executable(root=root, nbytes=nbytes)
    groups = ex.num_groups if groups is None else groups
    f = np.random.RandomState(100 + i).standard_normal(nbytes // 4)
    x = jnp.asarray(f.astype(np.float32)).astype(getattr(jnp, dt))
    arrays[f"in{i}"] = np.asarray(x).view(np.uint8)
    out = bbs_broadcast(x, mesh, "x", ex.schedule, groups)
    arrays[f"out{i}"] = np.asarray(out).view(np.uint8)
    fields = dataclasses.asdict(ex.schedule)
    for k, v in fields.items():
        if isinstance(v, np.ndarray):
            fields[k] = v.tolist()
    meta.append({"num_groups": groups, "schedule": fields})
np.savez(out_dir + "/ref.npz", **arrays)
json.dump(meta, open(out_dir + "/meta.json", "w"))
"""


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The cases run thousands of tiny CPU ops: one intra-op thread keeps
    them from contending with the other test workers' threads."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's stacked output, input and schedule of every case."""
    from repro_torch.device import import_schedule

    out = tmp_path_factory.mktemp("reference")
    (out / "cases.json").write_text(json.dumps(REF_CASES))
    env = dict(os.environ)
    # one thread a device keeps the 16 emulated devices off other tests'
    # cores
    env["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=16 "
                        "--xla_cpu_multi_thread_eigen=false "
                        "intra_op_parallelism_threads=1")
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    proc = subprocess.run([sys.executable, "-c", textwrap.dedent(REFERENCE),
                           str(out)], capture_output=True, text=True,
                          env=env, timeout=900)
    assert proc.returncode == 0, f"stdout:\n{proc.stdout}\n" \
                                 f"stderr:\n{proc.stderr}"
    arrays = dict(np.load(out / "ref.npz"))
    meta = json.loads((out / "meta.json").read_text())
    got = {}
    for i, case in enumerate(REF_CASES):
        dt = getattr(torch, case[4])
        x = torch.from_numpy(arrays[f"in{i}"].copy()).view(dt)
        got[case] = (x, import_schedule(meta[i]["schedule"]),
                     meta[i]["num_groups"], arrays[f"out{i}"])
    return got


def _bytes(t):
    return t.contiguous().view(torch.uint8).reshape(t.shape[0], -1).numpy()


def _staged(x, sched, groups):
    """The staged path on the CPU: sub-round tables, one step each."""
    return runner.broadcast(runner.LoweredPlan(sched, groups, x, "cpu"), x)


def _lowered(sched, groups, x):
    """The schedule lowered on the CPU with K1's moves asked for."""
    low = runner.LoweredPlan(sched, groups, x, "cpu")
    low.moves()
    return low


def _inplace(low, x, poison, monkeypatch):
    """The runner's composition with each request's fresh allocation
    poisoned before ``runner.fill_ref`` starts it: with 0xA5 bytes, or
    with the answer (scratch included) of another payload of the same
    shape, broadcast first. K1 runs by its plain version at the
    placement's byte offsets. Returns the output and its allocation."""
    allocs = []
    real = runner.fill_ref

    def fill_ref(alloc, xb, plc, root):
        if poison == "a5":
            alloc.fill_(0xA5)
        elif allocs:
            alloc.copy_(allocs[-1])
        allocs.append(alloc)
        real(alloc, xb, plc, root)

    monkeypatch.setattr(runner, "fill_ref", fill_ref)
    if poison == "answer":
        g = torch.Generator().manual_seed(9)
        other = torch.randint(0, 256, (x.numel() * x.element_size(),),
                              dtype=torch.uint8, generator=g).view(x.dtype)
        runner.broadcast(low, other)
    got = runner.broadcast(low, x)
    assert len(allocs) == (2 if poison == "answer" else 1)
    return got, allocs[-1]


@pytest.mark.parametrize("poison", ["a5", "answer"])
@pytest.mark.parametrize("case,covers", CASES,
                         ids=[f"{c[0]}-r{c[1]}-{c[2]}-{c[4]}"
                              for c, _ in CASES])
def test_inplace_outputs_byte_identical_to_staged_and_reference(
        reference, case, covers, poison, monkeypatch):
    x, sched, groups, want = reference[case]
    low = _lowered(sched, groups, x)
    plc = low.placement(x)
    lay, nbytes = plc.lay, x.numel() * x.element_size()
    assert plc.inplace and plc.nbytes == nbytes
    used16, past, relay = covers
    assert (lay.total - plc.full, lay.relay) == (past, relay)
    if used16 is not None:
        assert lay.used % 16 == used16
    assert plc.tail == nbytes - plc.full * lay.row_bytes
    got, alloc = _inplace(low, x, poison, monkeypatch)
    assert got.shape == (16,) + tuple(x.shape) and got.dtype == x.dtype
    assert got.is_contiguous() and got.data_ptr() == alloc.data_ptr()
    np.testing.assert_array_equal(_bytes(got), want.reshape(16, -1),
                                  err_msg=f"in place from {poison}, {case}")
    np.testing.assert_array_equal(_bytes(got), _bytes(_staged(x, sched,
                                                              groups)))


@pytest.mark.parametrize("case", [CASES[i][0] for i in (0, 2, 5, 7)],
                         ids=["relay", "chain", "tail0", "mesh"])
def test_runner_takes_the_inplace_path_for_moves(reference, case):
    """``broadcast`` on a plan lowered with K1's moves on the CPU takes the
    in-place path (one ``inplace_runs`` a broadcast, the spans of a
    request), reuses its cached placement, and answers as the reference
    does."""
    from repro_torch import spans

    x, sched, groups, want = reference[case]
    low = _lowered(sched, groups, x)
    before = (runner.inplace_runs, runner.staged_runs)
    spans.start()
    try:
        got = runner.broadcast(low, x)
        again = runner.broadcast(low, x)
    finally:
        names = [s.name for s in spans.stop()]
    assert (runner.inplace_runs - before[0],
            runner.staged_runs - before[1]) == (2, 0)
    assert len(low.placements) == 1 and \
        next(iter(low.placements.values())).inplace
    assert names == ["lower.place"] + \
        ["runner.pack", "runner.cycles", "runner.unpack"] * 2
    for out in (got, again):
        np.testing.assert_array_equal(_bytes(out), want.reshape(16, -1))


def test_unaligned_payload_takes_the_staged_path(reference):
    """``nbytes % 16 != 0``: a device's output would start off the 16-byte
    grid, so the rows stay staged; the moves' answer is the reference's."""
    x, sched, groups, want = reference[STAGED]
    low = _lowered(sched, groups, x)
    assert x.numel() * x.element_size() % 16 == 4
    assert not low.placement(x).inplace
    before = (runner.inplace_runs, runner.staged_runs)
    got = runner.broadcast(low, x)
    assert (runner.inplace_runs - before[0],
            runner.staged_runs - before[1]) == (0, 1)
    np.testing.assert_array_equal(_bytes(got), want.reshape(16, -1))


def _planted(sched, groups, lay):
    """The plan's sub-round tables behind one planted sub-round in which
    the root receives into its packet row 1 what device ``u`` holds in its
    packet row 0, before anything has written that row."""
    tabs = runner.slot_tables(sched, groups).reshape(-1, 5, lay.n)
    u = (sched.root + 1) % lay.n
    t = np.zeros((5, lay.n), dtype=np.int32)
    t[0] = -1
    t[0, sched.root], t[1, u], t[2, u] = u, 0, 1
    t[3, sched.root], t[4, sched.root] = 1, 1
    return np.concatenate([t[None], tabs])


def test_plan_reading_a_row_before_writing_it_stays_staged(reference,
                                                           monkeypatch):
    """A plan that reads a non-root packet row inside the payload before
    writing it fails ``writes_first``: ``place`` keeps it staged, and the
    runner counts a staged run whose answer is the sub-round chain's. The
    same plan forced in place carries the 0xA5 of the stale allocation into
    every device's output: the check is what keeps the layout exact."""
    x, sched, groups, want = reference[PLANTED]
    nbytes = x.numel() * x.element_size()
    plain = _lowered(sched, groups, x).placement(x)
    lay = plain.lay
    assert plain.inplace
    tabs = _planted(sched, groups, lay)
    moves = rs.compact_moves(tabs, lay.rows, lay.total)
    assert not runner.writes_first(moves, sched.root, nbytes // lay.row_bytes)
    monkeypatch.setattr(runner, "build_moves", lambda *args: moves)
    low = _lowered(sched, groups, x)
    assert low.moves() is moves and not low.placement(x).inplace
    before = (runner.inplace_runs, runner.staged_runs)
    got = runner.broadcast(low, x)
    assert (runner.inplace_runs - before[0],
            runner.staged_runs - before[1]) == (0, 1)
    buf = runner.pack(x, lay, sched.root, CPU)
    for t in torch.from_numpy(tabs):
        rs.permute_step_ref(buf, t)
    chain = runner.unpack(buf, lay, x)
    np.testing.assert_array_equal(_bytes(got), _bytes(chain))
    assert not np.array_equal(_bytes(got), want.reshape(16, -1))
    forced = low.placements[(x.shape, x.dtype)] = runner.Placement(
        lay, nbytes, moves.offsets(lay.row_bytes,
                                   runner.inplace_rows(lay, nbytes)))
    bad = _bytes(_inplace(low, x, "a5", monkeypatch)[0])
    assert not np.array_equal(bad, _bytes(chain))
    assert (bad == 0xA5).any()


def _cpu_exe(nbytes=64000, root=5):
    from repro_torch import api
    from repro_torch.core import topology as T
    from repro_torch.core.simconfig import DeviceConfig, SimConfig
    cpu = SimConfig(device=DeviceConfig(device="cpu"))
    return api.compile(T.mesh2d(4, 4)).executable(root, nbytes, config=cpu)


@pytest.mark.parametrize("program", ["tables", "moves"])
def test_run_and_measure_share_one_placement(program):
    """``ExecutablePlan.run`` and ``measure`` find the payload's placement
    in the one cache of the plan's ``LoweredPlan``: one entry after both,
    the same object, in place once K1's moves are asked for."""
    ex = _cpu_exe()
    getattr(ex, program)()
    x = ex.default_payload(seed=4)
    out = ex.run(x)
    low = ex.lowered
    assert len(low.placements) == 1
    plc = next(iter(low.placements.values()))
    assert ex.measure(x, reps=1) > 0
    assert list(low.placements.values()) == [plc]
    assert plc.inplace == (program == "moves")
    raw = x.view(torch.uint8)
    assert all(torch.equal(out[v].view(torch.uint8), raw) for v in range(16))


def test_staged_and_inplace_requests_share_one_composition(monkeypatch):
    """On one plan lowered with K1's moves, a payload of ``nbytes % 16 =
    4`` (staged) and one of a multiple of 16 (in place) both go through
    ``runner.broadcast`` once a request, under the same span names, and
    each delivers its payload to every device."""
    from repro_torch import spans

    ex = _cpu_exe()
    ex.moves()
    calls = []
    real = runner.broadcast
    monkeypatch.setattr(runner, "broadcast",
                        lambda low, x: calls.append(low) or real(low, x))
    g = torch.Generator().manual_seed(11)
    xs = {kind: torch.randint(0, 256, (nb,), dtype=torch.uint8,
                              generator=g).view(torch.float32)
          for kind, nb in (("staged", 64004), ("inplace", 64000))}
    names = {}
    for kind, x in xs.items():
        before = (runner.inplace_runs, runner.staged_runs)
        spans.start()
        try:
            out = ex.run(x)
        finally:
            names[kind] = [s.name for s in spans.stop()]
        assert (runner.inplace_runs - before[0],
                runner.staged_runs - before[1]) == \
            ((1, 0) if kind == "inplace" else (0, 1))
        raw = x.view(torch.uint8)
        assert all(torch.equal(out[v].view(torch.uint8), raw)
                   for v in range(16))
    assert calls == [ex.lowered] * 2
    assert names["staged"] == names["inplace"] == [
        "bcast.run", "lower.place", "runner.pack", "runner.cycles",
        "runner.unpack"]


def test_writes_first_reads_sub_round_order():
    """A row read in the sub-round that first writes it is read before the
    write (a sub-round's reads come first); a row never written fails; the
    root's rows and rows past ``full`` are not asked about."""
    n, rows = 3, 2
    # sub-round 0: device 1 row 0 <- device 0 row 0 (the root's);
    # sub-round 1: device 2 row 0 <- device 1 row 0, device 1 row 1 <- 0's 1
    pairs = [[1 * rows + 0, 0], [2 * rows + 0, 1 * rows + 0],
             [1 * rows + 1, 1]]
    ok = _moves(n, rows, pairs, [1, 2])
    assert runner.writes_first(ok, 0, 1)
    assert not runner.writes_first(ok, 0, 2)       # device 2's row 1: never
    assert runner.writes_first(ok, 2, 1) is False  # device 0's row 0: never
    # the semantics of the plain version; K1 itself is never asked to
    # read and write one row in a sub-round
    same = _moves(n, rows, [[1 * rows + 0, 0], [2 * rows + 0, 1 * rows + 0]],
                  [2])
    assert not runner.writes_first(same, 0, 1)
    assert runner.writes_first(_moves(n, rows, [], []), 0, 0)


def _moves(n, rows, pairs, counts):
    offs = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    zero = np.zeros_like(offs)
    return rs.Moves(pairs=torch.tensor(pairs, dtype=torch.int64).reshape(
        -1, 2), offs=torch.from_numpy(offs),
        counts=np.asarray(counts, dtype=np.int64), n=n, rows=rows,
        moves_cum=offs, zeros_cum=zero, relay_cum=zero,
        relay_zeros_cum=zero)


@pytest.mark.parametrize("n,rows,row_bytes,count,seed",
                         [(5, 4, 32, 12, 0), (17, 33, 16, 40, 1),
                          (64, 7, 48, 30, 2)])
def test_row_offsets_move_the_rows_of_any_placement(n, rows, row_bytes,
                                                    count, seed):
    """``Moves.offsets``: the staged offsets on the flat buffer, and a
    shuffled placement of the rows in a larger allocation, each give the
    ``[n, rows, row_bytes]`` buffer's answer, row for row; the staged ones
    are ``row * row_bytes`` and made once."""
    rng = np.random.default_rng(seed)
    tabs = np.stack([rs.random_table(rng, n, rows) for _ in range(count)])
    buf = torch.from_numpy(rng.integers(0, 256, (n, rows, row_bytes),
                                        dtype=np.uint8))
    moves = rs.compact_moves(tabs, rows)
    want = rs.permute_rounds_ref(buf.clone(), moves)
    at = moves.offsets(row_bytes)
    assert at is moves.offsets(row_bytes) and at.span == buf.numel()
    live = moves.pairs >= 0
    assert torch.equal(at.pairs[live], moves.pairs[live] * row_bytes)
    assert bool((at.pairs[~live] == -1).all())
    got = rs.permute_rounds(buf.clone().view(-1), moves, at=at)
    assert torch.equal(got.view(n, rows, row_bytes), want)
    slot = rng.permutation(n * rows + 5)[:n * rows]
    row_at = 16 + slot * row_bytes
    alloc = torch.from_numpy(rng.integers(0, 256, 16 + (n * rows + 5)
                                          * row_bytes, dtype=np.uint8))
    for i in range(n * rows):
        alloc[row_at[i]:row_at[i] + row_bytes] = buf.view(-1, row_bytes)[i]
    at = moves.offsets(row_bytes, row_at)
    assert at.span == int(row_at.max()) + row_bytes
    before = rs.moved_bytes
    rs.permute_rounds(alloc, moves, at=at)
    assert rs.moved_bytes - before == moves.moved_bytes(
        0, count, row_bytes)
    got = torch.stack([alloc[o:o + row_bytes] for o in row_at])
    assert torch.equal(got, want.view(-1, row_bytes))


def test_row_offsets_reject_bad_placements():
    moves = rs.compact_moves(rs.random_table(np.random.default_rng(0), 4,
                                             3)[None], 3)
    with pytest.raises(ValueError, match="16"):
        moves.offsets(20)
    with pytest.raises(ValueError, match="12 rows"):
        moves.offsets(16, np.arange(11) * 16)
    with pytest.raises(ValueError, match="multiples"):
        moves.offsets(16, np.arange(12) * 16 + 8)
    at = moves.offsets(16, np.arange(12) * 32)
    buf = torch.zeros(at.span - 1, dtype=torch.uint8)
    with pytest.raises(ValueError, match="at least"):
        rs.permute_rounds(buf, moves, at=at)


def test_inplace_rows_lay_out_output_then_scratch():
    """Row p of device v at ``v * nbytes + p * row_bytes`` while it lies
    wholly inside the payload; the rest after the output, device-major;
    every row 16-byte aligned, none overlapping, all inside the
    allocation."""
    lay = runner.PacketLayout(n=3, total=5, relay=2, plen=9, used=36,
                              row_bytes=48)
    nbytes = 176                         # 3 full rows and 32 bytes
    plc = runner.Placement(lay, nbytes)
    assert (plc.full, plc.scratch, plc.tail) == (3, 4, 32)
    assert plc.alloc_bytes == 3 * (176 + 4 * 48)
    at = runner.inplace_rows(lay, nbytes).reshape(3, 7)
    assert at[1, :3].tolist() == [176, 224, 272]
    assert at[0, 3:].tolist() == [528, 576, 624, 672]
    assert at[2, 3] == 528 + 8 * 48
    flat = np.sort(at.reshape(-1))
    assert (flat % 16 == 0).all() and (np.diff(flat) >= 48).all()
    assert flat[-1] + 48 == plc.alloc_bytes
