"""Port tests that need an NVIDIA GPU (marker ``cuda``): the hand-written
kernels (the round step K1 -- one sub-round a launch, and every sub-round
of a broadcast in one persistent launch, also as the calibration's ring
rounds --, flash attention K2, the SSD scan K3, the simulator's event
core) against their plain PyTorch versions, small broadcasts on the card against the same
broadcasts on the CPU, and the Mamba-2 and dense LMs on the card against
the CPU. They skip on a host
without a GPU; on the card run them with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

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


def test_kernels_refuse_grad_on_card(gpu):
    """K2 and K3 have no backward: an input that requires grad raises while
    grad is enabled; under ``no_grad`` the same call launches."""
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ssd_scan as K

    q, k, v = _attn_inputs(gpu, 3, 1, 4, 2, 64, 64, 64, torch.bfloat16)
    with pytest.raises(RuntimeError, match="backward"):
        FA.flash_attention(q.requires_grad_(), k, v)
    args = _ssd_inputs(gpu, 3, 1, 64, 2, 32, 16, torch.bfloat16)
    with pytest.raises(RuntimeError, match="backward"):
        K.ssd_scan(args[0], args[1].requires_grad_(), *args[2:])
    before = (FA.launches, K.launches)
    with torch.no_grad():
        FA.flash_attention(q, k, v)
        K.ssd_scan(*args)
    assert (FA.launches, K.launches) == (before[0] + 1, before[1] + 1)


SSD_SHAPES = [(1, 64, 2, 32, 16, 32), (2, 100, 4, 64, 32, 32),
              (1, 256, 2, 64, 128, 128), (1, 32, 8, 128, 64, 16),
              (2, 5, 3, 64, 128, 128), (2, 37, 3, 64, 128, 128),
              (2, 300, 3, 128, 64, 37), (1, 100, 2, 32, 16, 8)]


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
    ``event_core_ref`` returns; so does the scan kernel it replaced."""
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
    scan = KS.event_core_scan(*dev, durs.to(gpu))
    for g, sc, w in zip(got, scan, want):
        assert torch.equal(g.cpu(), w) and torch.equal(sc.cpu(), w)


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
    too large: ``variant`` picks each, and the kernel equals the scan
    kernel (itself held to ``event_core_ref`` above) on both."""
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
    want = KS.event_core_scan(*stat)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("zero_cap", [False, True])
@pytest.mark.parametrize("n,lanes", [(1, 1), (40, 3), (333, 5),
                                     (2100, 2)])
def test_event_core_kernel_random_structures(gpu, n, lanes, zero_cap):
    """Ties, repeated ids, dummy pads, one task and lists of up to 2,100;
    with ``zero_cap`` the completion step with ``min(fin)`` inf, where a
    done or unstarted task wins the scan of all n keys. The scan kernel
    agrees too."""
    from repro_torch.core import kernelsim as KS

    stat = [torch.from_numpy(a) for a in KS.random_structure(
        np.random.default_rng(n), n, lanes, nres=max(2, n // 8), K=4,
        D=3, zero_cap=zero_cap)]
    want = KS.event_core(*stat)
    got = KS.event_core(*(t.to(gpu) for t in stat))
    scan = KS.event_core_scan(*(t.to(gpu) for t in stat))
    for g, sc, w in zip(got, scan, want):
        assert torch.equal(g.cpu(), w) and torch.equal(sc.cpu(), w)


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
