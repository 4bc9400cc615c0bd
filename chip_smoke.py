#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which exits non-zero on failure:

1. build every CUDA kernel of the main paths with ``nvcc`` (sm_90a), all
   sources at once: ``permute_rounds`` (K1, every sub-round of a broadcast
   in one persistent launch), ``permute_step`` (K1's one-sub-round kernel,
   the yardstick), ``flash_attention`` (K2), ``ssd_scan`` (K3),
   ``event_core`` and ``event_core_scan`` (EC and its yardstick); print
   ptxas's registers and spills, and each K2, K3 and EC instance's shared
   memory (K2: bf16 tensor-core and float32 FMA kernels, five head dims
   each, bf16 D 112 on the D 128 tile; K3: ``ssd_tc<dh, ds>`` for bf16,
   twelve instances, and the float32 FMA kernel); a bf16 instance that
   spills fails;
2. hold ``permute_step`` bit-exact against its plain PyTorch version on the
   card: random tables with every edge case, float32 and bfloat16
   payloads, and a buffer over 2**31 bytes; then ``permute_rounds`` against
   ``permute_rounds_ref``: random sequences of 1, 7 and 64 sub-rounds with
   sub-rounds of count 0, n = 1, float32 and bfloat16 payloads, the main
   path's buffer over 2**32 bytes, two launches bit-identical;
3. the broadcast path: ``repro_torch.api.compile(mesh2d(16, 16)).executable(
   root=0, nbytes=16 MiB)`` on cuda -- 256 virtual devices, verified bit-exact
   on every device, in exactly one ``permute_rounds`` launch running d x
   cycles sub-rounds, and no ``permute_step`` launch;
4. small broadcasts (ring 8, hypercube 3; bbs and bine_tree; roots 0 and 3;
   bfloat16) on the card, each verified and held against the CPU run;
5. K1's timing at the broadcast's shape: the old design per launch (a CUDA
   graph of the 2,156 ``permute_step`` launches, so host launch cost is
   left out; and their eager loop), the new one (``measure()``: one
   ``permute_rounds`` launch a broadcast, min of 3; its barrier-only time,
   the same launch with every count 0; the wrapper's host time), the bound
   (bytes moved over the card's memory rate), the plain versions and the
   ``index_select``/``index_copy_`` yardstick;
6. the calibration path through a served, stored model
   (``api.compile(topo, server=True, store=PlanStore(tmp))``): ring 8 at
   4 MiB and mesh2d 16 x 16 at 16 MiB from root 255 (root 0's orbit: one
   plan build serves both roots), each ``executable`` verified bit-exact in
   one ``permute_rounds`` launch; the ring rounds ``measure_round`` times
   (``iters`` sub-rounds of the full ring in one launch) bit-exact against
   ``permute_rounds_ref`` at every size; ``ex.calibrate()`` (ring 8 at the
   reference bench cell's 8 KiB-1 MiB ladder, mesh2d at the default 1
   KiB-1 MiB) and ``prediction_report``: alpha >= 0, beta > 0, finite
   times, the ring 8 artifact stored and reloaded equal; alpha, beta, the
   fit residual, each size's time, predicted and measured cycle times and
   ``rel_err`` are printed as readings, not gated;
7. the simulator's event core (``csrc/event_core.cu``): the matrix of
   ``tests/test_kernel.py`` (4 topologies x 7 baselines x 4e4 and 64e6 B)
   through ``KernelSim.run_lowered(jit=True)`` and ``simulate_baseline(
   config=SimConfig(engine="kernel"))`` on cuda, every result equal to the
   numpy engine's, one launch per flat list and none for a foldable one;
   one grid-sweep row, mesh2d 32 x 32 srda at 12 sizes (11,263 tasks a
   lane), in one ``run_lowered_batch`` launch against 12 per-size numpy
   runs; mesh2d 64 x 64 glf and bine at 64e6 (the sweep's widest resource
   rows) and srda (its largest list, 53,247 tasks), and no launch of the
   scan kernel; then the kernel bit-exact against ``event_core_ref`` on the
   card (mesh2d 16 x 16 srda, 12 lanes), bit-equal to the scan kernel it
   replaced (``csrc/event_core_scan.cu``) on every timed shape, each
   shape's time of both (CUDA events, in turns: scan, new, new, scan), the
   new one's in both memory variants, time a step, the compaction's
   time, the numpy engine's time on the same lists and the bytes bound;
   and the step floor of the design: the kernel on a chain of tasks, one
   private resource each;
8. the distributed executor (``repro_torch.device.distributed``) over
   ``min(8, device_count)`` NCCL ranks, one GPU each, bit for bit against
   the virtual mesh, when the machine has two GPUs or more; on one GPU a
   line says it was not run and why;
9. hold K3 against its plain version (``ssd_chunked``) on the card: the
   Mamba-2 370M prefill shape in bf16, a ragged sequence, float32, the
   overflow regime (dt = 2, A = -1, where a multiplied mask gives NaN),
   chunk invariance in float32 and bf16, short and ragged bf16 chunks (8,
   37, 16), many waves of items (4 x 4096 x 32 heads), two bf16 launches
   bit-identical, and a ValueError for bf16 shapes the kernel does not take;
10. the serving path of Mamba-2 370M at full width (48 layers, random
   weights from seed 0): ``LM.prefill`` of 4 x 2048 ``SyntheticTokens`` with
   exactly one K3 launch per layer, finite logits, held against a prefill
   through the plain SSD; teacher-forced ``decode_step`` against
   ``forward`` over 4 x 256 tokens, in bf16 and in float32; and
   ``serve.main`` to (4, 32) greedy tokens;
11. K3's timing at the prefill shape (an eager loop of 20 launches; a CUDA
   graph of 20 and the wrapper's host time beside it; its bound, TFLOP/s,
   share of the bound, the plain version, the float32 FMA kernel), prefill
   and decode times, serve's tokens/s and the prefill's peak memory; then
   a ``torch.profiler`` window over one prefill and over four decode steps
   (the device's busy share and kernel time by kind);
12. hold K2 against its plain version (``attention_ref``) on the card: the
   llama3.2-3b prefill shape (B 4, Hq 32, Hkv 16, S = T = 2048, D 128) in
   bf16 and float32, ragged S = T = 2000, non-causal, the decode offset
   (S = 1 and S = 16 against T = 2048), S > T with fully-masked rows
   (exactly 0), the odd sizes 37/37 with D 32, and zamba2-7b's head dim
   112 at its prefill shape (4, 32, 32, 2048, 2048) in bf16 and float32;
13. the serving path of llama3.2-3b at full width (28 layers, random weights
   from seed 0), the Mamba-2 models freed first: ``LM.prefill`` of
   4 x 2048 ``SyntheticTokens`` with exactly one K2 launch per layer (and
   none of K1 and K3), finite logits, the peak memory; K2 against plain
   attention on every layer's own inputs; the float32 twin against its
   plain-attention prefill; teacher-forced ``decode_step`` against
   ``forward`` over 4 x 256 tokens in float32 and bf16, and a decode step
   after a ``prefill``-filled cache; the float32 twin rescaled to the
   reference's attention init, where ``attention_blockwise`` is held
   against ``attention_ref`` beside K2 (a reading: why the port's init is
   the fan-in); ``serve.main --arch llama3.2-3b`` to (4, 32) greedy tokens;
14. K2's timing at the prefill shape (an eager loop of five launches, the
   wrapper's host work included; a CUDA graph of five beside it, and the
   wrapper's host time per call): its bound (operations), TFLOP/s, share
   of the bound, the plain version and ``scaled_dot_product_attention`` as
   the library yardstick (timed both ways here only; the port never calls
   it) and K2's ratio to it; K2 at zamba2-7b's head dim 112 beside SDPA;
   the float32 FMA kernel once at the same shape; prefill time, decode time
   after a 4 x 2048 prefill, serve's tokens/s; a ``torch.profiler`` window
   over one dense prefill and the four decode steps after it.

The last lines are one JSON line with the calibration readings, one with
the distributed phase's (null on one GPU), the card
(``nvidia-smi`` name and power limit), one JSON line with every kernel, and
``{"ok": true, "device": {...}}``. Without a
GPU, or without the repo beside it, it exits non-zero and prints no result.
"""

import contextlib
import ctypes
import json
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")
MAIN_NBYTES = 16 << 20
# HBM rates of the SXM data sheets (bytes/s), by the name nvidia-smi reports
MEM_RATE = (("H200", 4.8e12), ("H100", 3.35e12))
BF16_PEAK = 989e12        # dense bf16 tensor-core FLOP/s (H100/H200 SXM)
FP32_PEAK = 67e12         # float32 FLOP/s outside the tensor cores (H100 SXM)
# the Mamba-2 370M prefill: batch, sequence, heads, head dim, state, chunk
SSD_MAIN = (4, 2048, 32, 64, 128, 128)
# the llama3.2-3b prefill's attention: batch, q heads (the TP padding's 32
# slots), kv heads (16), query rows, key columns, head dim
ATTN_MAIN = (4, 32, 16, 2048, 2048, 128)
# zamba2-7b's shared attention at a 4 x 2048 prefill (32 heads of 112)
ZAMBA_ATTN = (4, 32, 32, 2048, 2048, 112)
# the calibration cells: ring 8 at 4 MiB with the reference bench cell's
# ladder, iters and reps (benchmarks/simbench.py, device_collective); mesh2d
# 16 x 16 at 16 MiB from root 255 (root 0's orbit) at the default ladder
CAL_RING_NBYTES = 4 << 20
CAL_RING_SIZES = (8 << 10, 64 << 10, 256 << 10, 1 << 20)
CAL_SIZES = (1 << 10, 8 << 10, 64 << 10, 256 << 10, 1 << 20)
CAL_ITERS, CAL_REPS = 32, 5
BF16_TOL, F32_TOL, CHUNK_TOL = 2e-2, 3e-5, 1e-4   # tests/test_kernels.py
F32_MODEL_TOL = 1e-3      # float32 logits at full depth


def log(msg):
    print(msg, flush=True)


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0].strip()


def mem_rate(name):
    for key, rate in MEM_RATE:
        if key in name:
            return rate
    fail(f"no memory rate known for card {name!r}")


def cuda_ms(fn):
    """Milliseconds of one call of ``fn`` on the device, by CUDA events."""
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def graph_ms(torch, fn, reps):
    """Milliseconds per call of ``fn``, ``reps`` calls captured in one CUDA
    graph and replayed (min of 3), so the host's launch cost is left out."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    ms = min(cuda_ms(graph.replay) for _ in range(3)) / reps
    del graph
    return ms


def ptxas_kernels(report, pattern):
    """(match of ``pattern`` in the mangled name, registers, spill stores,
    spill loads, static shared memory in B) of every kernel in the ptxas
    report ``report`` (``-Xptxas -v``) whose name matches ``pattern``."""
    out, name, spills = [], None, (None, None)
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '([^']*)'", line)
        if m:
            name = re.search(pattern, m.group(1))
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name:
            spills = (int(m.group(1)), int(m.group(2)))
            continue
        m = re.search(r"Used (\d+) registers(?:.*?(\d+) bytes smem)?", line)
        if m and name:
            out.append((name, int(m.group(1)), *spills, int(m.group(2) or 0)))
            name = None
    return out


def phase_build(FA, K):
    from repro_torch import nvcc
    t0 = time.perf_counter()
    names = ["permute_rounds", "permute_step", "flash_attention", "ssd_scan",
             "event_core", "event_core_scan"]
    nvcc.build(names)
    log(f"[build] {', '.join(names)} built in "
        f"{time.perf_counter() - t0:.3f} s")
    k1 = {}
    for src in ("permute_rounds", "permute_step", "event_core_scan"):
        for line in nvcc.build_log(src).splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build]   {src}: {line.strip()}")
        (_, r, st, ld, _), = ptxas_kernels(nvcc.build_log(src), src)
        k1[src] = dict(registers=r, spill_stores=st, spill_loads=ld)
    ec = {}
    for m, r, st, ld, static in ptxas_kernels(
            nvcc.build_log("event_core"), r"event_core_kernelILb([01])E"):
        inst = ("global", "shared")[int(m.group(1))]
        ec[inst] = dict(registers=r, spill_stores=st, spill_loads=ld,
                        static_smem=static)
        log(f"[build]   event_core ({inst} variant): {r} registers, spill "
            f"stores {st} B, spill loads {ld} B, shared memory {static} B "
            f"static + the lane's dynamic share ([eventcore] rows)")
    if len(ec) != 2:
        fail(f"the ptxas report names {len(ec)} event_core instances, "
             f"expected 2")
    k1["event_core"] = dict(ec["shared"], instances=ec)
    lib = K._kernel()
    rows = []
    for m, *nums in ptxas_kernels(nvcc.build_log("ssd_scan"),
                                  r"(ssd_tc|ssd_fma)I(?:Li(\d+)ELi(\d+)E|f)"):
        bf16 = m.group(1) == "ssd_tc"
        inst = f"ssd_tc<{m.group(2)}, {m.group(3)}> (bf16)" if bf16 else \
            "ssd_fma<float> (float32)"
        # dynamic shared memory at chunk 128 (the FMA kernel's at dh 64, ds 128)
        dyn = lib.ssd_scan_smem(128, int(m.group(2)), int(m.group(3)), 1) \
            if bf16 else lib.ssd_scan_smem(128, 64, 128, 0)
        rows.append(("ssd_scan", inst, *nums, dyn))
    want = len(K.TC_HEAD_DIMS) * len(K.TC_STATE_DIMS) + 1
    if len(rows) != want:
        fail(f"the ptxas report names {len(rows)} K3 kernels, expected {want}")
    smem = (ctypes.c_int * (2 * len(FA.HEAD_DIMS))).in_dll(
        FA._kernel(), "flash_attention_smem")
    k2 = ptxas_kernels(nvcc.build_log("flash_attention"),
                       r"(attn_tc|attn_fma)ILi(\d+)E(?:Li(\d+)E)?")
    if len(k2) != 2 * len(FA.HEAD_DIMS):
        fail(f"the ptxas report names {len(k2)} K2 kernels, expected "
             f"{2 * len(FA.HEAD_DIMS)}")
    for m, *nums in k2:
        # attn_tc<D, DV> computes at D and stores DV columns
        bf16, d = m.group(1) == "attn_tc", int(m.group(3) or m.group(2))
        inst = f"attn_tc<{m.group(2)}, {d}>" if bf16 else f"attn_fma<{d}>"
        rows.append(("flash_attention", f"{inst} "
                     f"({'bf16' if bf16 else 'float32'})", *nums,
                     smem[bf16 * len(FA.HEAD_DIMS) + FA.HEAD_DIMS.index(d)]))
    for src, inst, regs, st, ld, static, dyn in rows:
        log(f"[build]   {src} {inst}: {regs} registers, spill stores {st} B, "
            f"spill loads {ld} B, shared memory {static} B static + {dyn} B "
            f"dynamic")
        if (st or ld) and "bf16" in inst:
            fail(f"{src} {inst} spills registers")
    return k1


def max_byte_diff(torch, a, b):
    """Largest |a - b| over two uint8 buffers, one leading slice at a time."""
    return max(int((a[i].to(torch.int16) - b[i].to(torch.int16)).abs().max())
               for i in range(a.shape[0]))


def far_rows(t, n, rows):
    """Make sub-round table ``t`` touch the buffer's last bytes: device n-1
    receives into its last row from device n-2's last row, and sends its
    second-to-last row to device 0; the table stays a matching without a
    send/receive clash."""
    src, s_ix, s_ok, r_ix, r_ok = t
    src[(src == n - 2) | (src == n - 1)] = -1
    src[n - 1], s_ix[n - 2], s_ok[n - 2] = n - 2, rows - 1, 1
    r_ix[n - 1], r_ok[n - 1] = rows - 1, 1
    src[0], s_ix[n - 1], s_ok[n - 1], r_ok[0] = n - 1, rows - 2, 1, 1
    r_ix[n - 2] = 0
    if s_ix[0] == r_ix[0]:
        r_ix[0] = (s_ix[0] + 1) % rows
    return t


def phase_kernel_vs_plain(np, torch, rs):
    """Returns the largest byte difference seen (0 when bit-exact)."""
    dev = torch.device("cuda")
    rng = np.random.default_rng(11)
    worst = 0

    def check(buf, tabs, what):
        nonlocal worst
        ref, got = buf.clone(), buf
        for t in tabs:
            rs.permute_step_ref(ref, t)
            rs.permute_step(got, t)
        torch.cuda.synchronize()
        worst = max(worst, max_byte_diff(torch, got, ref))
        if not torch.equal(got, ref):
            fail(f"kernel differs from plain version: {what}")
        log(f"[kernel] bit-exact: {what}")

    for dtype in (torch.float32, torch.bfloat16):
        n, rows, plen = 64, 41, 1531
        vals = torch.from_numpy(rng.standard_normal((n, rows, plen))
                                .astype(np.float32)).to(dtype)
        vals.view(-1)[::97] = float("nan")
        raw = vals.view(torch.uint8)
        row_bytes = -(-raw.shape[2] // 16) * 16
        buf = torch.zeros((n, rows, row_bytes), dtype=torch.uint8)
        buf[:, :, :raw.shape[2]] = raw
        tabs = [torch.from_numpy(rs.random_table(rng, n, rows)).to(dev)
                for _ in range(8)]
        check(buf.to(dev), tabs, f"{dtype} payload, n={n} rows={rows}, "
                                 f"8 random sub-rounds")
    # the main path's shape: 256 x 772 x 21,744 B = 4.3 GB, over 2**31 bytes;
    # the last device's last row sits past byte 2**32
    n, rows, row_bytes = 256, 772, 21744
    assert n * rows * row_bytes > 2 ** 31
    g = torch.Generator(device=dev).manual_seed(3)
    buf = torch.randint(0, 256, (n, rows, row_bytes), dtype=torch.uint8,
                        device=dev, generator=g)
    tabs = [torch.from_numpy(far_rows(rs.random_table(rng, n, rows), n,
                                      rows)).to(dev) for _ in range(3)]
    check(buf, tabs, f"{n * rows * row_bytes} B buffer (> 2**31), "
                     f"3 random sub-rounds")
    del buf
    torch.cuda.empty_cache()
    return worst


def phase_rounds_vs_plain(np, torch, rs):
    """``permute_rounds`` (every sub-round in one launch) against
    ``permute_rounds_ref`` on the card, bit-exact. Returns the largest byte
    difference seen (0 when bit-exact)."""
    dev = torch.device("cuda")
    rng = np.random.default_rng(12)
    worst = 0

    def check(buf, tabs, what, s0=0, s1=None):
        nonlocal worst
        moves = rs.compact_moves(tabs, buf.shape[1]).to(dev)
        want = rs.permute_rounds_ref(buf.clone(), moves, s0, s1)
        got = rs.permute_rounds(buf.clone(), moves, s0, s1)
        again = rs.permute_rounds(buf.clone(), moves, s0, s1)
        torch.cuda.synchronize()
        worst = max(worst, max_byte_diff(torch, got, want))
        if not torch.equal(got, want):
            fail(f"permute_rounds differs from plain version: {what}")
        if not torch.equal(again, got):
            fail(f"two permute_rounds launches differ: {what}")
        idle = int((moves.counts[s0:s1] == 0).sum())
        log(f"[rounds] bit-exact, two launches identical: {what} "
            f"({idle} sub-rounds of count 0)")
        del want, got, again

    def tables(n, rows, count):
        tabs = np.stack([rs.random_table(rng, n, rows)
                         for _ in range(count)])
        tabs[2::3, 4] = 0                    # no writer: the barrier alone
        return tabs

    for dtype in (torch.float32, torch.bfloat16):
        n, rows, plen = 64, 41, 1531
        vals = torch.from_numpy(rng.standard_normal((n, rows, plen))
                                .astype(np.float32)).to(dtype)
        vals.view(-1)[::97] = float("nan")
        raw = vals.view(torch.uint8)
        row_bytes = -(-raw.shape[2] // 16) * 16
        buf = torch.zeros((n, rows, row_bytes), dtype=torch.uint8)
        buf[:, :, :raw.shape[2]] = raw
        buf = buf.to(dev)
        for count in (1, 7, 64):
            check(buf, tables(n, rows, count), f"{dtype} payload, n={n} "
                  f"rows={rows}, {count} random sub-rounds")
    buf = torch.randint(0, 256, (1, 5, 4096), dtype=torch.uint8, device=dev)
    check(buf, tables(1, 5, 64), "n=1, 64 sub-rounds")
    check(buf[:, :1].contiguous(), tables(1, 1, 7), "n=1 rows=1, 7 "
          "sub-rounds")
    # the main path's shape: 256 x 772 x 21,744 B = 4.3 GB, over 2**32
    # bytes; the last device's last row sits past byte 2**32
    n, rows, row_bytes = 256, 772, 21744
    g = torch.Generator(device=dev).manual_seed(5)
    buf = torch.randint(0, 256, (n, rows, row_bytes), dtype=torch.uint8,
                        device=dev, generator=g)
    tabs = tables(n, rows, 7)
    for t in tabs[:2]:
        far_rows(t, n, rows)
    check(buf, tabs, f"{n * rows * row_bytes} B buffer (> 2**32), 7 random "
          f"sub-rounds")
    check(buf, tabs, "the same, sub-rounds [1, 5) of 7", 1, 5)
    del buf
    torch.cuda.empty_cache()
    return worst


def phase_main(torch, rs, api, T):
    model = api.compile(T.mesh2d(16, 16))
    t0 = time.perf_counter()
    ex = model.executable(root=0, nbytes=MAIN_NBYTES)
    t_build = time.perf_counter() - t0
    if ex.torch_device.type != "cuda":
        fail("main path is not on cuda")
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(MAIN_NBYTES // 4, device="cuda", generator=g)
    s = ex.schedule
    ex.moves()                       # compacted once per plan, set-up
    rs.launches = rs.rounds_launches = rs.subrounds = 0
    t0 = time.perf_counter()
    chk = ex.verify(x)
    torch.cuda.synchronize()
    t_verify = time.perf_counter() - t0
    launches, subrounds, steps = rs.rounds_launches, rs.subrounds, \
        rs.launches
    out = ex.run(x)
    if tuple(out.shape) != (256,) + tuple(x.shape) or \
            not torch.isfinite(out).all() or not torch.equal(out[255], x):
        fail(f"main path output: shape {tuple(out.shape)}, or non-finite or "
             f"unequal values")
    del out
    if not chk.ok:
        fail(f"main path: devices {chk.missing[:16]} differ from the payload")
    if launches != 1 or ex.num_launches != 1 or steps or \
            subrounds != ex.num_subrounds or \
            subrounds != s.d * s.num_cycles(ex.num_groups):
        fail(f"main path launched permute_rounds {launches} times for "
             f"{subrounds} sub-rounds (and permute_step {steps} times), "
             f"expected 1 launch for d x cycles = {ex.num_subrounds} "
             f"sub-rounds and none")
    from repro_torch.device import runner
    lay = runner.packet_layout(x, s, ex.num_groups)
    secs = ex.measure(x, reps=3)
    log(f"[main] mesh2d 16x16, {MAIN_NBYTES} B float32 from root 0: "
        f"candidate {ex.candidate}, K={s.K}, m={ex.num_groups}, d={s.d}, "
        f"cycles={s.num_cycles(ex.num_groups)}, relay rows={s.num_relay}, "
        f"{launches} permute_rounds launch for {subrounds} sub-rounds, "
        f"{int(ex.moves().counts.sum())} row moves, packet buffer "
        f"{lay.buffer_bytes} B ({lay.rows} rows x {lay.row_bytes} B x "
        f"{lay.n} devices)")
    log(f"[main] plan+tables build {t_build:.3f} s; verify (run + compare) "
        f"{t_verify:.3f} s; ok on all {len(chk.required)} devices")
    return ex, x, lay, launches, subrounds, steps, secs


def phase_small(torch, api, T, DeviceConfig, SimConfig):
    cpu = SimConfig(device=DeviceConfig(device="cpu"))
    for topo in (T.ring(8), T.hypercube(3)):
        model = api.compile(topo)
        for algo in ("bbs", "bine_tree"):
            for root in (0, 3):
                x = torch.linspace(-3, 3, 3001).to(torch.bfloat16)
                ex = model.executable(root=root, nbytes=2 * x.numel(),
                                      algo=algo)
                chk = ex.verify(x)
                out = ex.run(x).cpu()
                ref = model.executable(root=root, nbytes=2 * x.numel(),
                                       algo=algo, config=cpu).run(x)
                if not chk.ok or not torch.isfinite(out.float()).all() or \
                        not torch.equal(out.view(torch.int16),
                                        ref.view(torch.int16)):
                    fail(f"small case {topo.name} {algo} root {root}")
                log(f"[small] {topo.name} {algo} root {root} bf16: "
                    f"bit-exact on {len(chk.required)} devices and equal to "
                    f"the CPU run ({ex.candidate}, {ex.num_subrounds} "
                    f"sub-rounds in {ex.num_launches} launch)")


def phase_timing(np, torch, rs, runner, ex, x, lay, rate, secs):
    """K1 over the main path's whole cycle loop, both designs on one card:
    the old one launch per sub-round (``permute_step`` in a CUDA graph and
    in an eager loop, per launch), the new one launch per broadcast
    (``measure()``'s ``secs``; the same launch over the same sub-rounds with
    every count 0, the barriers alone; the wrapper's host time), the bytes
    bound, the plain versions and the ``index_select``/``index_copy_``
    yardstick."""
    dev = torch.device("cuda")
    tabs = ex.tables()
    moves = ex.moves()
    cycles, d = tabs.shape[:2]
    nl = cycles * d
    flat_tabs = [tabs[c, r] for c in range(cycles) for r in range(d)]
    # bytes this run's tables make the function move: a row written for
    # every receiver with r_ok, a row read for every live read
    host = tabs.cpu().numpy().reshape(nl, 5, -1)
    src, s_ix, s_ok, r_ix, r_ok = (host[:, i] for i in range(5))
    s_ok_of_src = np.take_along_axis(s_ok, np.clip(src, 0, None), axis=1)
    live = (r_ok != 0) & (src >= 0) & (s_ok_of_src != 0)
    nbytes = int(((r_ok != 0).sum() + live.sum()) * lay.row_bytes)
    pairs = moves.pairs.cpu().numpy()
    if int(moves.counts.sum()) != int((r_ok != 0).sum()) or \
            int((pairs[:, 1] >= 0).sum()) != int(live.sum()):
        fail("the compacted moves do not count the tables' writes and reads")
    bound_ms = nbytes / rate * 1e3
    # a reading for later work: runs of consecutive sub-rounds in which no
    # row is written by one and read or written by another (the barriers
    # a schedule of conflict-free runs would keep), counted on the host
    offs = np.concatenate([[0], np.cumsum(moves.counts)])
    runs, seen_r, seen_w = 0, set(), set()
    for i in range(nl):
        p = pairs[offs[i]:offs[i + 1]]
        w, r = set(p[:, 0].tolist()), set(p[p[:, 1] >= 0, 1].tolist())
        if not runs or r & seen_w or w & (seen_r | seen_w):
            runs, seen_r, seen_w = runs + 1, set(), set()
        seen_r |= r
        seen_w |= w

    buf = runner.pack(x, lay, ex.root, dev)
    step_graph_ms = graph_ms(torch, lambda: [rs.permute_step(buf, t)
                                             for t in flat_tabs], 1)
    step_eager_ms = min(cuda_ms(lambda: [rs.permute_step(buf, t)
                                         for t in flat_tabs])
                        for _ in range(2))

    idle = rs.Moves(pairs=moves.pairs[:0], offs=torch.zeros_like(moves.offs),
                    counts=np.zeros_like(moves.counts), n=moves.n,
                    rows=moves.rows)
    barrier_ms = min(cuda_ms(lambda: rs.permute_rounds(buf, idle))
                     for _ in range(3))
    reps = 10
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        rs.permute_rounds(buf, moves)
    host_ms = (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize()
    rounds_plain_ms = cuda_ms(lambda: rs.permute_rounds_ref(buf, moves))
    step_plain_ms = cuda_ms(lambda: [rs.permute_step_ref(buf, t)
                                     for t in flat_tabs])

    flat = buf.view(lay.n * lay.rows, lay.row_bytes)
    rows_ix = []
    for i in range(nl):
        w = live[i].nonzero()[0]
        u = src[i][w].astype(np.int64)
        rows_ix.append((torch.from_numpy(u * lay.rows + s_ix[i][u]).to(dev),
                        torch.from_numpy(w * lay.rows + r_ix[i][w]).to(dev)))

    def library():
        for s_rows, d_rows in rows_ix:
            flat.index_copy_(0, d_rows, flat.index_select(0, s_rows))
    library()
    library_ms = min(cuda_ms(library) for _ in range(2))
    del buf, flat
    blocks, threads = rs.rounds_grid()
    ms = secs * 1e3
    log(f"[timing] permute_rounds (one launch, {nl} sub-rounds, a "
        f"cooperative grid of {blocks} blocks x {threads} threads): "
        f"{ms!r} ms a broadcast (measure(), min of 3), {ms / nl * 1e3!r} us "
        f"a sub-round, {bound_ms / ms!r} of its {bound_ms!r} ms bound "
        f"({nbytes} B at {rate / 1e12:.2f} TB/s); barrier-only (every count "
        f"0) {barrier_ms!r} ms, {barrier_ms / nl * 1e3!r} us a sub-round; "
        f"the wrapper's host time {host_ms!r} ms a call; plain "
        f"(permute_rounds_ref) {rounds_plain_ms!r} ms; {runs} runs of "
        f"conflict-free consecutive sub-rounds")
    log(f"[timing] permute_step (the old design, {nl} launches): "
        f"{step_graph_ms!r} ms in a CUDA graph ({step_graph_ms / nl * 1e3!r} "
        f"us a launch), {step_eager_ms!r} ms in an eager loop "
        f"({step_eager_ms / nl * 1e3!r} us a launch); plain "
        f"(permute_step_ref) {step_plain_ms!r} ms; index_select + "
        f"index_copy_ {library_ms!r} ms; permute_rounds takes "
        f"{ms / step_graph_ms!r} of the graph's time")
    return dict(ms=ms, barrier_ms=barrier_ms, host_ms=host_ms,
                plain_ms=rounds_plain_ms, bound_ms=bound_ms, bytes=nbytes,
                library_ms=library_ms, blocks=blocks, threads=threads,
                step_ms=step_graph_ms / nl, step_graph_ms=step_graph_ms,
                step_eager_ms=step_eager_ms / nl,
                step_plain_ms=step_plain_ms / nl,
                step_library_ms=library_ms / nl,
                step_bound_ms=bound_ms / nl, subrounds=nl,
                conflict_free_runs=runs)


def calibration_cell(torch, rs, C, model, root, nbytes, sizes, what):
    """One calibration cell on the card: ``model.executable(root, nbytes)``
    verified bit-exact in exactly one ``permute_rounds`` launch; the ring
    ladder at every size bit-exact against ``permute_rounds_ref``; then
    ``ex.calibrate`` and ``prediction_report``, with the counts gated.
    Returns (executable, cost, readings)."""
    ex = model.executable(root=root, nbytes=nbytes)
    if ex.torch_device.type != "cuda":
        fail(f"calibration cell {what} is not on cuda")
    x = ex.default_payload(seed=root)
    ex.moves()
    rs.launches = rs.rounds_launches = rs.subrounds = 0
    chk = ex.verify(x)
    torch.cuda.synchronize()
    if not chk.ok:
        fail(f"calibration cell {what}: devices {chk.missing[:16]} differ "
             f"from the payload")
    if (rs.rounds_launches, rs.subrounds, rs.launches) != \
            (1, ex.num_subrounds, 0):
        fail(f"calibration cell {what}: verify launched permute_rounds "
             f"{rs.rounds_launches} times for {rs.subrounds} sub-rounds and "
             f"permute_step {rs.launches} times, expected 1 for "
             f"{ex.num_subrounds} and none")
    n = ex.schedule.num_devices
    worst = 0
    for size in sizes:
        buf, moves = C.ring_round(n, size, "cuda", CAL_ITERS)
        want = rs.permute_rounds_ref(buf.clone(), moves, 0, CAL_ITERS)
        rs.permute_rounds(buf, moves, 0, CAL_ITERS)
        torch.cuda.synchronize()
        worst = max(worst, max_byte_diff(torch, buf, want))
        if not torch.equal(buf, want) or not C.ring_delivered(buf):
            fail(f"calibration cell {what}: the ring rounds at {size} B "
                 f"differ from permute_rounds_ref")
        del buf, want
    rs.launches = rs.rounds_launches = rs.subrounds = 0
    cost = ex.calibrate(sizes=sizes, iters=CAL_ITERS, reps=CAL_REPS)
    want = len(sizes) * (CAL_REPS + 1)
    if (rs.rounds_launches, rs.subrounds, rs.launches) != \
            (want, want * CAL_ITERS, 0):
        fail(f"calibration cell {what}: calibrate launched permute_rounds "
             f"{rs.rounds_launches} times for {rs.subrounds} sub-rounds, "
             f"expected {want} for {want * CAL_ITERS}")
    (cls, (alpha, beta)), = cost.classes.items()
    times = cost.meta["round_seconds"]
    if not (0 <= alpha < float("inf") and all(
            0 < t < float("inf") for t in times + [beta])):
        fail(f"calibration cell {what}: alpha {alpha}, beta {beta}, round "
             f"times {times}")
    row, = C.prediction_report([ex], cost, reps=CAL_REPS)
    if not 0 < row.measured_cycle_s < float("inf") or \
            not 0 < row.predicted_cycle_s < float("inf"):
        fail(f"calibration cell {what}: report {row}")
    s = ex.schedule
    rows = [n * 2 * r for r in cost.meta["row_bytes"]]
    log(f"[calibrate] {what}: {ex.candidate}, K={s.K}, m={ex.num_groups}, "
        f"d={s.d}, cycles={row.num_cycles}, {ex.num_subrounds} sub-rounds "
        f"verified on {n} devices in 1 permute_rounds launch; ring ladder "
        f"bit-exact at {len(sizes)} sizes")
    for size, rb, buf_b, t in zip(sizes, cost.meta["row_bytes"], rows,
                                  times):
        log(f"[calibrate]   {what} {size} B a link (row {rb} B, buffer "
            f"{buf_b} B): {t * 1e6!r} us a round")
    log(f"[calibrate] {what}: class {cls}, alpha {alpha * 1e6!r} us, beta "
        f"{beta / 1e9!r} GB/s, fit residual "
        f"{cost.meta['fit_residual_seconds'] * 1e6!r} us; cycle predicted "
        f"{row.predicted_cycle_s * 1e6!r} us, measured "
        f"{row.measured_cycle_s * 1e6!r} us, rel_err {row.rel_err!r}")
    return ex, cost, dict(
        topo=ex.topo.name, root=root, nbytes=nbytes, candidate=ex.candidate,
        devices=n, cycles=row.num_cycles, subrounds=ex.num_subrounds,
        link_class=cls, alpha_s=alpha, beta_bytes_per_s=beta,
        fit_residual_s=cost.meta["fit_residual_seconds"],
        sizes=list(sizes), row_bytes=cost.meta["row_bytes"],
        buffer_bytes=rows, round_s=times,
        predicted_cycle_s=row.predicted_cycle_s,
        measured_cycle_s=row.measured_cycle_s, rel_err=row.rel_err,
        ladder_max_abs_err=worst)


def phase_calibrate(torch, rs, api, T):
    """The calibration path (``repro_torch.device.calibrate``) through a
    served, stored model: ring 8 at 4 MiB and mesh2d 16 x 16 at 16 MiB
    from root 255, each in ``calibration_cell``; the ring 8 artifact stored
    and reloaded equal; one plan build for mesh2d's roots 0 and 255."""
    import importlib
    import tempfile
    from repro_torch.core.planstore import CalibrationKey, PlanStore
    C = importlib.import_module("repro_torch.device.calibrate")

    t0 = time.perf_counter()
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        store = PlanStore(tmp)
        topo = T.ring(8)
        model = api.compile(topo, server=True, store=store)
        ex, cost, out["ring8"] = calibration_cell(
            torch, rs, C, model, 0, CAL_RING_NBYTES, CAL_RING_SIZES,
            "ring8 4 MiB")
        key = CalibrationKey.for_topology(topo, "cuda", 8)
        path = store.store_calibration(key, cost)
        back, _ = PlanStore(tmp).load_calibration(key)
        if back != cost:
            fail(f"the calibration artifact {path} came back changed")
        log(f"[calibrate] ring8 artifact stored and reloaded equal "
            f"({os.path.basename(path)})")
        # a reading: the launch's fixed cost inside a round of the ladder,
        # from the smallest size's round over 1,024 sub-rounds a launch
        long_s = C.measure_round(8, CAL_RING_SIZES[0], iters=1024,
                                 reps=CAL_REPS)
        out["ring8"]["round_s_at_1024_iters"] = long_s
        log(f"[calibrate] ring8 {CAL_RING_SIZES[0]} B a link: "
            f"{long_s * 1e6!r} us a round over 1024 sub-rounds a launch "
            f"(against {out['ring8']['round_s'][0] * 1e6!r} us over "
            f"{CAL_ITERS})")
        del ex

        mesh = api.compile(T.mesh2d(16, 16), server=True, store=store)
        ex0 = mesh.executable(root=0, nbytes=MAIN_NBYTES)
        ex, _, out["mesh2d"] = calibration_cell(
            torch, rs, C, mesh, 255, MAIN_NBYTES, CAL_SIZES,
            "mesh2d 16x16 16 MiB root 255")
        st = mesh.server.stats
        if st.builds != 1 or st.relabels < 1 or \
                ex.num_subrounds != ex0.num_subrounds:
            fail(f"mesh2d roots 0 and 255: {st.builds} plan builds and "
                 f"{st.relabels} relabels (expected 1 build), "
                 f"{ex.num_subrounds} against {ex0.num_subrounds} "
                 f"sub-rounds")
        log(f"[calibrate] mesh2d roots 0 and 255: {st.builds} plan build "
            f"({st.build_seconds:.3f} s), {st.relabels} relabel "
            f"({st.relabel_seconds:.3f} s)")
        out["mesh2d"].update(builds=st.builds, relabels=st.relabels)
        del ex, ex0
    torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t0
    log(f"[calibrate] phase time {out['phase_s']:.3f} s")
    return out


# the event core's lists: tests/test_kernel.py's matrix, one grid-sweep row
# in lanes (benchmarks/gridsweep.py's 12 sizes) and the sweep's widest
# resource rows
EC_TOPOS = (("mesh2d-4x6", "mesh2d", (4, 6), "full_duplex"),
            ("mesh2d-16x16", "mesh2d", (16, 16), "full_duplex"),
            ("dragonfly", "dragonfly", (4, 4, 2), "all_port"),
            ("fat_tree", "fat_tree", (4,), "full_duplex"))
EC_NAMES = ("binomial", "flat", "pipeline", "srda", "glf", "bine",
            "mpi_bcast")
EC_MATRIX_SIZES = (4e4, 64e6)
EC_SWEEP_LANES = 12       # np.geomspace(1e5, 1e9, 12)
EC_FLOOR_TASKS = (4096, 16384)   # the step floor's chains
DIST_NBYTES = 16 << 20


def same_result(a, b):
    return (a.finish_time == b.finish_time and a.deliveries == b.deliveries
            and a.node_finish == b.node_finish
            and a.group_finish == b.group_finish
            and a.started == b.started and a.completed == b.completed)


def event_core_bytes(st, lanes):
    """Bytes the event core must move for ``lanes`` lanes of one structure:
    the compacted structure (``kernelsim.Compacted``: the ranks, the rows of
    entries that can block, the capacities, counts and children) read once,
    each lane's durations read once and its completion times and sequence
    numbers written once."""
    n = st.rank.numel()
    return sum(t.numel() * t.element_size() for t in st) + lanes * n * 20


def chain_structure(np, n):
    """The step floor's list: task i depends on task i - 1 and holds one
    private resource, so each step admits or completes one task, checks a
    one-entry row and wakes no one."""
    rank = np.arange(n, dtype=np.int32)
    res = np.arange(n, dtype=np.int32)[:, None]
    caps = np.ones(n, dtype=np.int32)
    deps = np.arange(-1, n - 1, dtype=np.int32)[:, None]
    deps[0, 0] = n
    durs = np.ones((1, n))
    return rank, res, caps, deps, durs


def phase_eventcore(np, torch, rate):
    """The simulator's event core on the card (``repro_torch.core.kernelsim``,
    ``csrc/event_core.cu``). Main path: ``tests/test_kernel.py``'s matrix
    through ``KernelSim.run_lowered(jit=True)`` and
    ``simulate_baseline(config=SimConfig(engine="kernel"))``, each equal to
    the numpy engine's result (every field), one launch per non-foldable
    list and none for a foldable one; one grid-sweep row (mesh2d 32 x 32
    srda at 12 sizes) in one ``run_lowered_batch`` launch against 12
    per-size numpy runs; the sweep's widest resource rows (mesh2d 64 x 64
    glf and bine at 64e6) and its largest list (64 x 64 srda). Then,
    outside the main path's count: the kernel against ``event_core_ref`` on
    the card (mesh2d 16 x 16 srda, 12 lanes); on each shape the kernel
    bit-equal to the scan kernel it replaced (``event_core_scan``), both
    timed in turns (scan, new, new, scan; CUDA events), the new one also in
    the global memory variant where the shared one fits, a step's time and
    where it goes (``kernelsim.profile``), the compaction's time, the numpy
    engine's time on the same lists (host clock) and the bytes bound,
    which is not what limits a chain of 2n dependent steps; and the step
    floor of this design, the kernel on a chain of tasks."""
    from repro_torch.core import kernelsim as KS
    from repro_torch.core import topology as T
    from repro_torch.core.baselines import lower_baseline, simulate_baseline
    from repro_torch.core.fastsim import CompiledSim
    from repro_torch.core.intersection import ConflictModel
    from repro_torch.core.simconfig import SimConfig

    t0 = time.perf_counter()
    sizes = np.geomspace(1e5, 1e9, EC_SWEEP_LANES).tolist()
    kcfg, fcfg = SimConfig(engine="kernel"), SimConfig(engine="fast")
    models = {}

    def model(kind, args, mode="full_duplex"):
        key = (kind, args, mode)
        if key not in models:
            topo = getattr(T, kind)(*args)
            models[key] = (topo, ConflictModel(topo, mode))
        return models[key]

    KS.launches = KS.scan_launches = 0
    cases = core_lists = 0
    for tname, kind, args, mode in EC_TOPOS:
        topo, cm = model(kind, args, mode)
        ks, nsim = KS.KernelSim(topo, cm, 0), CompiledSim(topo, cm, 0)
        for name in EC_NAMES:
            for size in EC_MATRIX_SIZES:
                ctl = lower_baseline(topo, cm, name, 0, size)
                fold = ctl.seg is not None and ctl.seg.foldable
                before = KS.launches
                got = ks.run_lowered(ctl, jit=True)
                api_k = simulate_baseline(topo, cm, name, 0, size,
                                          config=kcfg)
                moved = KS.launches - before
                if not same_result(got, nsim.run_lowered(ctl)) or \
                        not same_result(api_k, simulate_baseline(
                            topo, cm, name, 0, size, config=fcfg)):
                    fail(f"[eventcore] {tname} {name} {size:g}: the kernel "
                         f"engine differs from the numpy engine")
                if moved != (0 if fold else 2):
                    fail(f"[eventcore] {tname} {name} {size:g}: "
                         f"{moved} event_core launches for a "
                         f"{'foldable' if fold else 'flat'} list of "
                         f"{ctl.n} tasks (expected {0 if fold else 2})")
                cases += 1
                core_lists += not fold
    log(f"[eventcore] tests/test_kernel.py matrix: {cases} lists equal to "
        f"the numpy engine through run_lowered(jit=True) and "
        f"simulate_baseline(engine='kernel'); {core_lists} flat lists took "
        f"the kernel ({KS.launches} launches), {cases - core_lists} "
        f"foldable lists none")

    shapes = {}
    topo, cm = model("mesh2d", (32, 32))
    ctl, durs, nbytes = KS.lower_baseline_lanes(topo, cm, "srda", 0, sizes)
    before = KS.launches
    got = KS.KernelSim(topo, cm, 0).run_lowered_batch(ctl, durs, nbytes)
    if KS.launches != before + 1:
        fail(f"[eventcore] the sweep row took {KS.launches - before} "
             f"launches, expected 1")
    shapes["sweep"] = (topo, cm, ctl, durs, [
        lower_baseline(topo, cm, "srda", 0, s) for s in sizes])
    nsim = CompiledSim(topo, cm, 0)
    for lane, (g, c) in enumerate(zip(got, shapes["sweep"][4])):
        if not same_result(g, nsim.run_lowered(c)):
            fail(f"[eventcore] sweep lane {lane} ({sizes[lane]:g} B) "
                 f"differs from the numpy engine")
    log(f"[eventcore] mesh2d 32x32 srda, {EC_SWEEP_LANES} lanes of "
        f"{ctl.n} tasks in one launch: every lane equal to its per-size "
        f"numpy run")
    topo, cm = model("mesh2d", (64, 64))
    ks, nsim = KS.KernelSim(topo, cm, 0), CompiledSim(topo, cm, 0)
    numpy_ms = {}
    for name in ("glf", "bine", "srda"):
        c = lower_baseline(topo, cm, name, 0, 64e6)
        before = KS.launches
        g = ks.run_lowered(c)
        t1 = time.perf_counter()
        want = nsim.run_lowered(c)
        numpy_ms[name] = (time.perf_counter() - t1) * 1e3
        if KS.launches != before + 1 or not same_result(g, want):
            fail(f"[eventcore] mesh2d 64x64 {name}: {KS.launches - before} "
                 f"launches, or the result differs from the numpy engine")
        shapes[name] = (topo, cm, c, np.asarray([c.durs]), [c])
        log(f"[eventcore] mesh2d 64x64 {name} at 64e6: {c.n} tasks, "
            f"resource rows {max(len(r) for r in c.res_ids)} wide, equal "
            f"to the numpy engine")
    launches, scan_launches = KS.launches, KS.scan_launches
    if scan_launches:
        fail(f"[eventcore] the main path launched event_core_scan "
             f"{KS.scan_launches} times")

    # the kernel against the plain version on the card
    topo, cm = model("mesh2d", (16, 16))
    c16, d16, _ = KS.lower_baseline_lanes(topo, cm, "srda", 0, sizes)
    shapes["plain"] = (topo, cm, c16, d16, [
        lower_baseline(topo, cm, "srda", 0, s) for s in sizes])
    out = {}
    for key, (topo, cm, c, d, ctls) in shapes.items():
        c.bind(cm.compiled())
        stat = [torch.from_numpy(a).cuda() for a in
                KS._static_arrays(c, cm.compiled())]
        dt = torch.from_numpy(np.ascontiguousarray(d)).cuda()
        row = eventcore_times(torch, KS, stat, dt, rate, key)
        if key in numpy_ms:
            row["numpy_ms"] = numpy_ms[key]
        else:
            nsim = CompiledSim(topo, cm, 0)
            t1 = time.perf_counter()
            for one in ctls:
                nsim.run_lowered(one)
            row["numpy_ms"] = (time.perf_counter() - t1) * 1e3
        if key == "plain":
            got = KS.event_core(*stat, dt)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            want = KS.event_core_ref(*stat, dt)
            torch.cuda.synchronize()
            row["plain_ms"] = (time.perf_counter() - t1) * 1e3
            row["mismatches"] = int((got[0] != want[0]).sum()) + \
                int((got[1] != want[1]).sum())
            row["max_abs_err"] = float((got[0] - want[0]).abs().nan_to_num(
                0.0).max())
            if row["mismatches"] or not torch.equal(got[0], want[0]):
                fail(f"[eventcore] the kernel differs from event_core_ref in "
                     f"{row['mismatches']} elements (mesh2d 16x16 srda, "
                     f"{d.shape[0]} lanes)")
            log(f"[eventcore] kernel bit-exact against event_core_ref on "
                f"the card: mesh2d 16x16 srda, {d.shape[0]} lanes of "
                f"{c.n} tasks (plain {row['plain_ms']!r} ms once)")
        out[key] = row
        log(f"[eventcore] {key}: {c.n} tasks x {d.shape[0]} lanes (K "
            f"{row['K']}, D {row['D']}, {row['W']} resources, {row['kept']} "
            f"kept; {row['entries']} row entries kept of "
            f"{row['padded_entries']}; {row['memory']} memory, "
            f"{row['smem']} B dynamic shared memory): kernel {row['ms']!r} "
            f"ms ({row['us_per_step']!r} us a step of {row['steps']}; by "
            f"memory variant {row['variants_ms']}), scan kernel "
            f"{row['scan_ms']!r} ms ({row['scan_us_per_step']!r} us a "
            f"step), bit-equal; compaction {row['prep_ms']!r} ms; numpy "
            f"engine {row['numpy_ms']!r} ms on the same lists; bytes bound "
            f"{row['bound_ms']!r} ms (not what limits 2n dependent steps)")

    floor = {}
    for n in EC_FLOOR_TASKS:
        stat = [torch.from_numpy(a).cuda() for a in chain_structure(np, n)]
        st = KS.compact_structure(*stat[:4])
        KS.launch(st, stat[4])                             # warm-up
        ms = min(cuda_ms(lambda: KS.launch(st, stat[4])) for _ in range(3))
        want = torch.arange(1, n + 1, dtype=torch.float64,
                            device=stat[4].device)
        if not torch.equal(KS.launch(st, stat[4])[0][0], want):
            fail(f"[eventcore] the chain of {n} tasks did not complete at "
                 f"1, 2, ..., n")
        floor[n] = dict(ms=ms, us_per_step=ms * 1e3 / (2 * n),
                        profile=eventcore_profile(KS, st, stat[4],
                                                  f"chain of {n}"))
        log(f"[eventcore] step floor of this design (not of the card): a "
            f"chain of {n} tasks, one private resource each, {ms!r} ms = "
            f"{floor[n]['us_per_step']!r} us a step of {2 * n}")
    out["floor"] = floor
    out["floor_us_per_step"] = min(f["us_per_step"] for f in floor.values())
    out["matrix_lists"], out["matrix_core_lists"] = cases, core_lists
    out["launches"], out["scan_launches"] = launches, scan_launches
    out["phase_s"] = time.perf_counter() - t0
    log(f"[eventcore] phase time {out['phase_s']:.3f} s")
    return out


def eventcore_profile(KS, st, dt, key):
    """Where a step's time goes on this shape: the kernel built with
    ``EC_PROFILE`` (``kernelsim.profile``), lane 0's clock cycles of each
    phase a step and its counts a task."""
    n = st.rank.numel()
    prof = KS.profile(st, dt)
    cyc = {k: v / (2 * n) for k, v in prof["cycles"].items()}
    cnt = {k: v / n for k, v in prof["counts"].items()}
    log(f"[eventcore] {key} profile (lane 0, EC_PROFILE build): cycles a "
        f"step {sum(cyc.values())!r}: " +
        ", ".join(f"{k} {v!r}" for k, v in cyc.items()) + "; a task: " +
        ", ".join(f"{k} {v!r}" for k, v in cnt.items()))
    return dict(cycles_per_step=cyc, counts_per_task=cnt)


def eventcore_times(torch, KS, stat, dt, rate, key):
    """The event core on one shape: the new kernel against the scan kernel,
    bit for bit, each timed in turns (scan, new, new, scan; CUDA events,
    one call a turn after a warm-up of each), the new one also in the global
    memory variant where the shared one fits; the compaction's time; the
    bytes bound."""
    L, n = dt.shape
    st = KS.compact_structure(*stat)
    torch.cuda.synchronize()
    prep_ms = min(cuda_ms(lambda: KS.compact_structure(*stat))
                  for _ in range(3))
    new = KS.launch(st, dt)
    scan = KS.event_core_scan(*stat, dt)
    scan_err = float((new[0] - scan[0]).abs().nan_to_num(0.0).max())
    if not (torch.equal(new[0], scan[0]) and torch.equal(new[1], scan[1])):
        fail(f"[eventcore] {key}: the kernel differs from event_core_scan "
             f"(largest difference {scan_err!r})")
    turns = [cuda_ms(lambda: KS.event_core_scan(*stat, dt)),
             cuda_ms(lambda: KS.launch(st, dt)),
             cuda_ms(lambda: KS.launch(st, dt)),
             cuda_ms(lambda: KS.event_core_scan(*stat, dt))]
    memory = KS.variant(n, st.caps.numel())
    variants_ms = {memory: min(turns[1:3])}
    if memory == "shared":
        got = KS.launch(st, dt, memory="global")
        if not (torch.equal(got[0], scan[0]) and torch.equal(got[1],
                                                             scan[1])):
            fail(f"[eventcore] {key}: the global variant differs from "
                 f"event_core_scan")
        variants_ms["global"] = cuda_ms(lambda: KS.launch(st, dt,
                                                          memory="global"))
    lib = KS._kernel()
    ms, scan_ms = min(turns[1:3]), min(turns[0], turns[3])
    prof = eventcore_profile(KS, st, dt, key)
    return dict(tasks=n, lanes=L, steps=2 * n, K=stat[1].shape[1],
                D=stat[3].shape[1], W=stat[2].shape[0],
                kept=st.caps.numel(), entries=st.row_res.numel(),
                padded_entries=stat[1].numel(), memory=memory,
                smem=lib.event_core_shared_bytes(
                    n, st.caps.numel(), int(memory == "shared")),
                ms=ms, us_per_step=ms * 1e3 / (2 * n), turns_ms=turns,
                scan_ms=scan_ms, scan_us_per_step=scan_ms * 1e3 / (2 * n),
                variants_ms=variants_ms, prep_ms=prep_ms, scan_err=scan_err,
                profile=prof,
                bound_ms=event_core_bytes(st, L) / rate * 1e3)


def distributed_rank(rank, world, backend, device, store, out):
    """One rank of ``phase_distributed``: ring ``world`` BBS broadcasts from
    roots 0 and world - 1 across the group, each rank's copy against the
    virtual mesh's on this rank's device and against the payload; writes
    ``out.<rank>.json``."""
    import torch
    import torch.distributed as dist
    sys.path.insert(0, SRC)
    from repro_torch import api
    from repro_torch.core import topology as T
    from repro_torch.core.simconfig import DeviceConfig, SimConfig

    dist.init_process_group(backend, store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    res = {}
    try:
        cfg = SimConfig(device=DeviceConfig(device=device))
        model = api.compile(T.ring(world))
        g = torch.Generator().manual_seed(0)
        x = torch.randn(DIST_NBYTES // 4, generator=g)
        for root in (0, world - 1):
            ex = model.executable(root=root, nbytes=DIST_NBYTES, config=cfg)
            mine = ex.run(x, group=dist.group.WORLD)
            virtual = ex.run(x)[rank]
            chk = ex.verify(x, group=dist.group.WORLD)
            times = []
            for _ in range(3):
                dist.barrier(device_ids=[mine.device.index]) if mine.is_cuda \
                    else dist.barrier()
                t0 = time.perf_counter()
                ex.run(x, group=dist.group.WORLD)
                if mine.is_cuda:
                    torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
            res[str(root)] = dict(
                equal=bool(torch.equal(mine.view(torch.uint8),
                                       virtual.view(torch.uint8))),
                ok=chk.ok, missing=list(chk.missing), device=str(mine.device),
                subrounds=ex.num_subrounds, ms=min(times) * 1e3)
    finally:
        dist.destroy_process_group()
    with open(f"{out}.{rank}.json", "w") as f:
        json.dump(res, f)


def phase_distributed(torch, world=None, backend="nccl", device="cuda"):
    """The distributed executor (``repro_torch.device.distributed``) over
    ``min(8, device_count)`` NCCL ranks, one GPU each, when the machine has
    two or more GPUs: ring BBS broadcasts of 16 MiB, each rank's copy bit
    for bit against the virtual mesh's. On one GPU it is not run (NCCL puts
    no two ranks on one GPU) and says so. ``world``, ``backend`` and
    ``device`` let a CPU rehearsal run it on gloo."""
    import multiprocessing as mp
    import tempfile
    if world is None:
        count = torch.cuda.device_count()
        if count < 2:
            log(f"[distributed] not run: {count} GPU visible, and NCCL "
                f"cannot put two ranks on one GPU; the executor is held "
                f"bit for bit on 8 gloo ranks by "
                f"tests/test_torch_distributed.py")
            return None
        world = min(8, count)
    t0 = time.perf_counter()
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "rank")
        procs = [ctx.Process(target=distributed_rank, args=(
            r, world, backend, device, os.path.join(tmp, "store"), out))
            for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + 300
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
        codes = [p.exitcode for p in procs]
        if codes != [0] * world:
            fail(f"[distributed] rank exit codes {codes}")
        ranks = []
        for r in range(world):
            with open(f"{out}.{r}.json") as f:
                ranks.append(json.load(f))
    res = {}
    for root in ranks[0]:
        rows = [rk[root] for rk in ranks]
        bad = [r for r, row in enumerate(rows)
               if not (row["equal"] and row["ok"] and not row["missing"])]
        if bad:
            fail(f"[distributed] ring {world} root {root}: ranks {bad} differ "
                 f"from the virtual mesh or the payload")
        ms = max(row["ms"] for row in rows)
        res[root] = dict(ms=ms, subrounds=rows[0]["subrounds"],
                         devices=[row["device"] for row in rows])
        log(f"[distributed] {backend} ring {world} root {root}, "
            f"{DIST_NBYTES} B: every rank bit-exact against the virtual "
            f"mesh and the payload ({rows[0]['subrounds']} sub-rounds; "
            f"{ms!r} ms a broadcast, host clock, slowest rank, min of 3; "
            f"devices {res[root]['devices']})")
    log(f"[distributed] phase time {time.perf_counter() - t0:.3f} s")
    return dict(world=world, backend=backend, roots=res)


def ssd_inputs(torch, b, s, h, dh, ds, dtype, seed, dt_value=None, a=None):
    """SSD inputs on the card, from a seed: x, B, C in ``dtype``, dt float32
    (softplus of a normal, times 0.1, as the reference's kernel sweep; or a
    constant), A = -exp(normal) (or a constant)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(b, s, h, dh, device="cuda", generator=g).to(dtype)
    dt = torch.nn.functional.softplus(
        torch.randn(b, s, h, device="cuda", generator=g)) * 0.1
    if dt_value is not None:
        dt = torch.full_like(dt, dt_value)
    A = -torch.exp(torch.randn(h, device="cuda", generator=g))
    if a is not None:
        A = torch.full_like(A, a)
    B = torch.randn(b, s, h, ds, device="cuda", generator=g).to(dtype)
    C = torch.randn(b, s, h, ds, device="cuda", generator=g).to(dtype)
    return x, dt, A, B, C


def compare(torch, got, want, tol, what, quiet=False, tag="ssd"):
    """Fails unless |got - want| <= tol + tol |want| everywhere (and both
    are finite); returns the largest |got - want|."""
    got, want = got.float(), want.float()
    if not torch.isfinite(got).all():
        fail(f"{what}: non-finite values")
    err = (got - want).abs()
    worst = float(err.max())
    bad = int((err > tol + tol * want.abs()).sum())
    if not quiet:
        log(f"[{tag}] {what}: max_abs_err {worst!r} (max |want| "
            f"{float(want.abs().max())!r}, tolerance {tol} abs + {tol} rel)")
    if bad:
        fail(f"{what}: {bad} values outside the tolerance "
             f"(max_abs_err {worst!r})")
    return worst


def phase_ssd_vs_plain(torch, K, ref):
    """K3 against its plain version on the card. Returns the max abs error
    at the prefill shape (bf16)."""
    b, s, h, dh, ds, chunk = SSD_MAIN
    bf, f32 = torch.bfloat16, torch.float32
    args = ssd_inputs(torch, b, s, h, dh, ds, bf, 1)
    main_err = compare(torch, K.ssd_scan(*args, chunk=chunk),
                       ref.ssd_chunked(*args, chunk=chunk), BF16_TOL,
                       f"prefill shape {SSD_MAIN} bf16")
    args = ssd_inputs(torch, b, 2000, h, dh, ds, bf, 2)
    compare(torch, K.ssd_scan(*args, chunk=chunk),
            ref.ssd_chunked(*args, chunk=chunk), BF16_TOL,
            "ragged s=2000 bf16")
    args = ssd_inputs(torch, b, s, h, dh, ds, f32, 3)
    compare(torch, K.ssd_scan(*args, chunk=chunk),
            ref.ssd_chunked(*args, chunk=chunk), F32_TOL,
            f"prefill shape {SSD_MAIN} float32")
    for dtype, tol in ((f32, F32_TOL), (bf, BF16_TOL)):
        args = ssd_inputs(torch, 2, 256, 4, dh, ds, dtype, 4, dt_value=2.0,
                          a=-1.0)
        got = K.ssd_scan(*args, chunk=chunk)
        compare(torch, got, ref.ssd_chunked(*args, chunk=chunk), tol,
                f"overflow dt=2 A=-1 s=256 {dtype} vs plain")
        compare(torch, got, ref.ssd_ref(*args), tol,
                f"overflow dt=2 A=-1 s=256 {dtype} vs sequential scan")
    for dtype, tol in ((f32, CHUNK_TOL), (bf, BF16_TOL)):
        args = ssd_inputs(torch, 1, 128, 2, 32, 16, dtype, 5)
        outs = [K.ssd_scan(*args, chunk=c) for c in (16, 32, 64, 128)]
        for c, o in zip((32, 64, 128), outs[1:]):
            compare(torch, o, outs[0], tol, f"chunk {c} vs chunk 16 {dtype}")
    # short and ragged chunks of the bf16 kernel: 8 steps (s = 5), 37
    # (s = 37), 37 with a ragged tail, 16 at head dim 32 and state 16
    for seed, (s_, dh_, ds_, c_) in enumerate(((5, 64, 128, 128),
                                               (37, 64, 128, 128),
                                               (300, 128, 64, 37),
                                               (100, 32, 16, 16))):
        args = ssd_inputs(torch, 2, s_, 3, dh_, ds_, bf, 30 + seed)
        compare(torch, K.ssd_scan(*args, chunk=c_),
                ref.ssd_chunked(*args, chunk=c_), BF16_TOL,
                f"s={s_} dh={dh_} ds={ds_} chunk {c_} (chunk_of "
                f"{K.chunk_of(s_, c_)}) bf16")
    # many waves of items: 4 x 32 x 32 = 4,096 (b, h, chunk) items
    args = ssd_inputs(torch, b, 4096, h, dh, ds, bf, 7)
    got = K.ssd_scan(*args, chunk=chunk)
    compare(torch, got, ref.ssd_chunked(*args, chunk=chunk), BF16_TOL,
            f"many waves (4, 4096, 32, 64, 128) bf16")
    again = K.ssd_scan(*args, chunk=chunk)
    if not torch.equal(got.view(torch.int16), again.view(torch.int16)):
        fail("two launches of the bf16 kernel differ")
    log("[ssd] two launches at (4, 4096, 32, 64, 128) bf16: bit-identical")
    del args, got, again
    for what, shape, c_ in (("dhead 16", (1, 64, 2, 16, 64), 64),
                            ("dstate 256", (1, 64, 2, 64, 256), 64),
                            ("chunk 256", (1, 512, 2, 64, 128), 256)):
        args = ssd_inputs(torch, *shape, bf, 8)
        try:
            K.ssd_scan(*args, chunk=c_)
        except ValueError as e:
            log(f"[ssd] bf16 {what} raises ValueError: {e}")
        else:
            fail(f"bf16 {what}: no ValueError")
    torch.cuda.synchronize()
    return main_err


def logits_err(torch, got, want, what, tol=None, bound=None):
    """Max |got - want| over (B, S, V) logits, one batch row at a time, and
    the share of positions with the same top-1 token. Fails on non-finite
    logits, outside ``tol`` abs + ``tol`` rel elementwise, or past an
    absolute ``bound`` on the max."""
    worst, bad, agree = 0.0, 0, 0
    for i in range(got.shape[0]):
        g, w = got[i].float(), want[i].float()
        if not torch.isfinite(g).all():
            fail(f"{what}: non-finite logits")
        err = (g - w).abs()
        worst = max(worst, float(err.max()))
        if tol is not None:
            bad += int((err > tol + tol * w.abs()).sum())
        agree += int((g.argmax(-1) == w.argmax(-1)).sum())
    share = agree / (got.shape[0] * got.shape[1])
    rule = (f"tolerance {tol} abs + {tol} rel" if tol is not None else
            f"bound {bound!r}" if bound is not None else "a yardstick")
    log(f"[lm] {what}: max_abs_err {worst!r}, top-1 agreement {share!r} "
        f"({rule})")
    if bad or (bound is not None and worst > bound):
        fail(f"{what}: outside the {rule}")
    return worst


@contextlib.contextmanager
def ssd_as(ops, fn):
    """Within the block the model's SSD is ``fn``; yields the real one."""
    real = ops.ssd
    ops.ssd = fn
    try:
        yield real
    finally:
        ops.ssd = real


def phase_prefill(torch, K, rs, ref, ops, cfg, LM, SyntheticTokens):
    """The serving path's prefill at full width. bf16 rounding grows with
    depth (48 layers of random weights), so K3 is held to its plain version
    three ways: on every layer's real inputs (the bf16 kernel tolerance), on
    the whole prefill in float32 (same weights, F32_MODEL_TOL), and on the
    whole prefill in bf16 within twice bf16's own distance from float32.
    Returns the bf16 model, its float32 twin and the numbers."""
    b, s = SSD_MAIN[:2]
    model = LM(cfg)
    batch = SyntheticTokens(cfg, seq_len=s, global_batch=b).batch(0)
    cache = model.init_cache(b, s)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.launches = rs.launches = rs.rounds_launches = 0
    logits, cache = model.prefill(batch, cache)
    torch.cuda.synchronize()
    launches = K.launches
    peak = torch.cuda.max_memory_allocated()
    if launches != cfg.layers or rs.launches or rs.rounds_launches:
        fail(f"prefill launched ssd_scan {launches} times (and permute_step "
             f"{rs.launches}, permute_rounds {rs.rounds_launches}), expected "
             f"{cfg.layers}, 0 and 0")
    want_shape = (b, s, cfg.padded_vocab)
    if tuple(logits.shape) != want_shape:
        fail(f"prefill logits {tuple(logits.shape)}, expected {want_shape}")
    if not all(bool(torch.isfinite(logits[i]).all()) for i in range(b)):
        fail("prefill logits are not finite")
    ms = min(cuda_ms(lambda: model.prefill(batch, cache)) for _ in range(2))
    log(f"[lm] {cfg.name}: {sum(p.numel() for p in model.parameters())} "
        f"parameters; prefill {b}x{s}: {launches} ssd_scan launches, finite "
        f"logits {want_shape}, {ms!r} ms, {b * s / ms * 1e3!r} tokens/s, "
        f"peak memory {peak} B")

    errs = []

    def checked(x, dt, A, B, C):
        y = kernel(x, dt, A, B, C)
        errs.append(compare(torch, y, ref.ssd_chunked(x, dt, A, B, C),
                            BF16_TOL, f"layer {len(errs)}", quiet=True))
        return y

    with ssd_as(ops, checked) as kernel:
        model.forward(batch)
    layer_err = max(errs)
    log(f"[lm] K3 vs plain on each layer's own inputs ({len(errs)} layers, "
        f"bf16): max_abs_err {layer_err!r} (tolerance {BF16_TOL} abs + "
        f"{BF16_TOL} rel)")

    f32 = LM(cfg.scaled(dtype="float32"))
    f32.load_state_dict(model.state_dict())     # the same weights, widened
    got32 = f32.forward(batch)
    with ssd_as(ops, ref.ssd_chunked):
        plain32 = f32.forward(batch)
    err32 = logits_err(torch, got32, plain32, f"prefill {b}x{s} float32: "
                       f"K3 vs plain SSD", tol=F32_MODEL_TOL)
    del got32
    with ssd_as(ops, ref.ssd_chunked):
        plain16 = model.forward(batch)
    noise = logits_err(torch, plain16, plain32, f"prefill {b}x{s}: plain "
                       f"SSD bf16 vs float32 (bf16's own error)")
    err = logits_err(torch, logits, plain16, f"prefill {b}x{s} bf16: K3 vs "
                     f"plain SSD", bound=2 * noise)
    del logits, plain16, plain32
    torch.cuda.empty_cache()
    return model, f32, dict(launches=launches, ms=ms, peak=peak, err=err,
                            err32=err32, layer_err=layer_err)


def decode_vs_forward(torch, model, tokens, what, **rule):
    full = model.forward(dict(tokens=tokens))
    cache = model.init_cache(tokens.shape[0], tokens.shape[1])
    steps = torch.empty_like(full)
    for t in range(tokens.shape[1]):
        steps[:, t] = model.decode_step(cache, tokens[:, t:t + 1])[0][:, 0]
    return logits_err(torch, steps, full, what, **rule), full


def phase_decode(torch, model, f32, cfg, SyntheticTokens):
    """Teacher-forced decode against forward over 4 x 256 tokens, at full
    depth: in float32 within F32_MODEL_TOL, in bf16 within twice bf16's own
    distance from float32 (as in the prefill)."""
    toks = SyntheticTokens(cfg, seq_len=256, global_batch=4).batch(1)
    toks = toks["tokens"].cuda()
    err32, full32 = decode_vs_forward(
        torch, f32, toks, f"decode_step vs forward, 4x256, float32, "
        f"{cfg.layers} layers", tol=F32_MODEL_TOL)
    full16 = model.forward(dict(tokens=toks))
    noise = logits_err(torch, full16, full32, "forward 4x256 bf16 vs "
                       "float32 (bf16's own error)")
    del full16, full32
    err, _ = decode_vs_forward(torch, model, toks, f"decode_step vs forward, "
                               f"4x256, bf16, {cfg.layers} layers",
                               bound=2 * noise)
    return err, err32, noise


def phase_serve(torch, serve, cfg):
    gen = serve.main(["--arch", cfg.name, "--batch", "4",
                      "--prompt-len", "32", "--tokens", "32"])
    if tuple(gen.shape) != (4, 32) or gen.dtype != torch.int32 or \
            int(gen.min()) < 0 or int(gen.max()) >= cfg.padded_vocab:
        fail(f"serve returned {gen.dtype} {tuple(gen.shape)} tokens")
    log(f"[serve] serve.main --arch {cfg.name}: (4, 32) greedy tokens; "
        f"first row "
        f"{gen[0, :8].tolist()}")


def phase_ssd_timing(torch, K, ref, rate):
    """K3 at the prefill shape in bf16 (the tensor-core kernel): ``ms`` the
    minimum of 2 eager loops of 20 launches over 20 (the wrapper's host work
    included); ``graph_ms`` the same 20 launches in a CUDA graph; ``host_ms``
    the wrapper's host time per call (20 calls issued back to back); its
    bound (the function's bytes and FLOP, full C B^T and W x tiles, not the
    split's extra products), TFLOP/s and share of the bound on those FLOP;
    the plain version; then the float32 FMA kernel once at the same
    shape."""
    b, s, h, dh, ds, chunk = SSD_MAIN
    args = ssd_inputs(torch, b, s, h, dh, ds, torch.bfloat16, 6)
    y = K.ssd_scan(*args, chunk=chunk)
    nbytes = sum(t.numel() * t.element_size() for t in args + (y,))
    nc = -(-s // chunk)
    flops = b * h * nc * (2 * chunk * chunk * (ds + dh) + 4 * chunk * ds * dh)
    bound_ms = max(nbytes / rate, flops / BF16_PEAK) * 1e3
    bound_by = "bytes" if nbytes / rate >= flops / BF16_PEAK else "operations"
    reps = 20

    def kernel():
        return K.ssd_scan(*args, chunk=chunk)
    kernel_ms = min(cuda_ms(lambda: [kernel() for _ in range(reps)])
                    for _ in range(2)) / reps
    kernel_graph_ms = graph_ms(torch, kernel, reps)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        kernel()
    host_ms = (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize()
    plain_ms = min(cuda_ms(lambda: ref.ssd_chunked(*args, chunk=chunk))
                   for _ in range(3))
    tflops = flops / kernel_ms / 1e9
    log(f"[timing] ssd_scan at {SSD_MAIN}, bf16: kernel {kernel_ms!r} ms per "
        f"launch (eager loop of {reps}; CUDA graph of {reps}: "
        f"{kernel_graph_ms!r} ms; the wrapper's host time {host_ms!r} ms a "
        f"call), bound {bound_ms!r} ms ({bound_by}: {nbytes} B at "
        f"{rate / 1e12:.2f} TB/s, {flops} FLOP at 989 TFLOP/s), "
        f"{tflops!r} TFLOP/s eager, {flops / kernel_graph_ms / 1e9!r} in the "
        f"graph; {bound_ms / kernel_ms!r} / {bound_ms / kernel_graph_ms!r} "
        f"of its bound; plain {plain_ms!r} ms; library: none (no single "
        f"PyTorch call computes the SSD scan)")
    del args, y
    args = ssd_inputs(torch, b, s, h, dh, ds, torch.float32, 6)
    f32_ms = min(cuda_ms(lambda: K.ssd_scan(*args, chunk=chunk))
                 for _ in range(2))
    log(f"[timing] ssd_scan at {SSD_MAIN}, float32 (FMA kernel): {f32_ms!r} "
        f"ms per launch, {flops / f32_ms / 1e9!r} TFLOP/s")
    del args
    torch.cuda.empty_cache()
    return dict(ms=kernel_ms, graph_ms=kernel_graph_ms, host_ms=host_ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                tflops=tflops, share_of_bound=bound_ms / kernel_ms,
                f32_ms=f32_ms)


def phase_decode_timing(torch, model, serve, SyntheticTokens, cfg):
    """``decode_step`` at batch 4 after a 4 x 2048 prefill (a dense cache of
    2048 + 64 slots, all of which every step reads), then the serve loop."""
    b, s = SSD_MAIN[:2]          # both families prefill 4 x 2048
    batch = SyntheticTokens(cfg, seq_len=s, global_batch=b).batch(2)
    cache = model.init_cache(b, s + 64)
    model.prefill(batch, cache)
    cur = batch["tokens"][:, :1].cuda()
    model.decode_step(cache, cur)
    n = 32
    step_ms = cuda_ms(lambda: [model.decode_step(cache, cur)
                               for _ in range(n)]) / n
    del cache
    toks = SyntheticTokens(cfg, seq_len=32, global_batch=4).batch(2)
    res = serve.generate(model, toks["tokens"], 32)
    log(f"[timing] {cfg.name} decode_step, batch 4, after a {b}x{s} "
        f"prefill: {step_ms!r} ms per step (eager); "
        f"serve loop (prompt 32, 32 new tokens, batch 4): fill "
        f"{res.fill_s!r} s, generate {res.gen_s!r} s, "
        f"{res.tok_per_s!r} tok/s")
    return dict(step_ms=step_ms, tok_per_s=res.tok_per_s)


def profile_window(torch, fn, what):
    """Runs ``fn`` once under ``torch.profiler`` and logs the device's busy
    share of the window (kernel time over host wall time, both ended by a
    synchronize) and the kernel time by kind. Returns the kernel times."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + \
                e.time_range.elapsed_us()
    busy = sum(by_name.values())
    kinds = {"flash_attention (K2)": 0.0, "ssd_scan (K3)": 0.0,
             "matmul": 0.0, "other": 0.0}
    for n, us in by_name.items():
        k = "flash_attention (K2)" if "attn_tc" in n or "attn_fma" in n \
            else \
            "ssd_scan (K3)" if "ssd_tc" in n or "ssd_fma" in n else \
            "matmul" if any(w in n.lower() for w in (
                "gemm", "gemv", "nvjet", "xmma", "cutlass")) else "other"
        kinds[k] += us
    log(f"[profile] {what}: kernels busy {busy / 1e3!r} ms of a "
        f"{wall_us / 1e3!r} ms window (profiler on), busy share "
        f"{busy / wall_us!r}; " + ", ".join(
            f"{k} {v / 1e3!r} ms" for k, v in kinds.items()))
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    for n, us in top:
        log(f"[profile]   {us / 1e3:10.3f} ms  {n[:100]}")
    return kinds, busy, wall_us


def phase_profile(torch, model, cfg, SyntheticTokens):
    b, s = SSD_MAIN[:2]          # both families prefill 4 x 2048
    batch = SyntheticTokens(cfg, seq_len=s, global_batch=b).batch(0)
    cache = model.init_cache(b, s + 64)
    profile_window(torch, lambda: model.prefill(batch, cache),
                   f"{cfg.name} prefill {b}x{s}")
    cur = batch["tokens"][:, :1].cuda()
    profile_window(torch, lambda: [model.decode_step(cache, cur)
                                   for _ in range(4)],
                   f"{cfg.name} 4 decode steps after the prefill, batch {b}")


def attn_inputs(torch, b, hq, hkv, s, t, d, dtype, seed):
    """q (b, hq, s, d), k and v (b, hkv, t, d) on the card, normal, from a
    seed."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    return tuple(torch.randn(shape, device="cuda", generator=g).to(dtype)
                 for shape in ((b, hq, s, d), (b, hkv, t, d), (b, hkv, t, d)))


def phase_attn_vs_plain(torch, FA, ref):
    """K2 against its plain version on the card. Returns the max abs error
    at the prefill shape (bf16)."""
    b, hq, hkv, s, t, d = ATTN_MAIN
    bf, f32 = torch.bfloat16, torch.float32
    cases = [("prefill shape bf16", (b, hq, hkv, s, t, d), bf, True),
             ("prefill shape float32", (b, hq, hkv, s, t, d), f32, True),
             ("ragged S=T=2000 bf16", (b, hq, hkv, 2000, 2000, d), bf, True),
             ("non-causal S=T=2048 bf16", (b, hq, hkv, s, t, d), bf, False),
             ("decode S=1 T=2048 float32", (b, hq, hkv, 1, t, d), f32, True),
             ("decode S=1 T=2048 bf16", (b, hq, hkv, 1, t, d), bf, True),
             ("decode S=16 T=2048 float32", (b, hq, hkv, 16, t, d), f32,
              True),
             ("decode S=16 T=2048 bf16", (b, hq, hkv, 16, t, d), bf, True),
             ("S=300 > T=200 causal float32", (2, 8, 4, 300, 200, d), f32,
              True),
             ("S=300 > T=200 causal bf16", (2, 8, 4, 300, 200, d), bf, True),
             ("odd 37/37 D 32 float32", (2, 4, 4, 37, 37, 32), f32, True),
             ("odd 37/37 D 32 bf16", (2, 4, 4, 37, 37, 32), bf, True),
             ("odd 37/37 D 32 non-causal float32", (2, 4, 4, 37, 37, 32),
              f32, False),
             # zamba2-7b's head dim 112 at its prefill shape: bf16 on the
             # D 128 tile with zero-filled columns, float32 on attn_fma<112>
             ("zamba2-7b prefill shape D 112 bf16", ZAMBA_ATTN, bf, True),
             ("zamba2-7b prefill shape D 112 float32", ZAMBA_ATTN, f32,
              True),
             ("ragged S=T=300 D 112 non-causal bf16", (2, 8, 4, 300, 300,
                                                       112), bf, False)]
    main_err = None
    for i, (what, shape, dtype, causal) in enumerate(cases):
        args = attn_inputs(torch, *shape, dtype, 20 + i)
        got = FA.flash_attention(*args, causal=causal)
        err = compare(torch, got, ref.attention_ref(*args, causal=causal),
                      BF16_TOL if dtype == bf else F32_TOL, what, tag="attn")
        main_err = err if main_err is None else main_err
        sq, tk = shape[3], shape[4]
        if causal and sq > tk:
            if got[:, :, :sq - tk].any():
                fail(f"{what}: fully-masked rows are not 0")
            log(f"[attn] {what}: the {sq - tk} fully-masked rows are 0")
        del args, got
    torch.cuda.synchronize()
    return main_err


@contextlib.contextmanager
def attention_as(ops, fn):
    """Within the block the model's attention is ``fn``; yields the real
    one."""
    real = ops.attention
    ops.attention = fn
    try:
        yield real
    finally:
        ops.attention = real


def phase_dense_prefill(torch, FA, K, rs, ref, ops, cfg, LM,
                        SyntheticTokens):
    """The dense serving path's prefill at full width, with K2 held to plain
    attention three ways, as K3 is in ``phase_prefill``: on every layer's
    own inputs (the bf16 kernel tolerance), on the whole prefill in float32
    (same weights, F32_MODEL_TOL), and on the whole prefill in bf16 within
    twice bf16's own distance from float32. Returns the bf16 model, its
    float32 twin and the numbers."""
    b, s = ATTN_MAIN[0], ATTN_MAIN[3]
    model = LM(cfg)
    batch = SyntheticTokens(cfg, seq_len=s, global_batch=b).batch(0)
    cache = model.init_cache(b, s)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    FA.launches = K.launches = rs.launches = rs.rounds_launches = 0
    logits, cache = model.prefill(batch, cache)
    torch.cuda.synchronize()
    launches = FA.launches
    peak = torch.cuda.max_memory_allocated()
    if launches != cfg.layers or K.launches or rs.launches or \
            rs.rounds_launches:
        fail(f"dense prefill launched flash_attention {launches} times (and "
             f"ssd_scan {K.launches}, permute_step {rs.launches}, "
             f"permute_rounds {rs.rounds_launches}), expected {cfg.layers}, "
             f"0, 0 and 0")
    if int(cache["pos"]) != s or not bool(cache["k"][:, :, :, s - 1].any()):
        fail("the prefill did not fill the k/v cache")
    want_shape = (b, s, cfg.padded_vocab)
    if tuple(logits.shape) != want_shape:
        fail(f"prefill logits {tuple(logits.shape)}, expected {want_shape}")
    if not all(bool(torch.isfinite(logits[i]).all()) for i in range(b)):
        fail("prefill logits are not finite")
    ms = min(cuda_ms(lambda: model.prefill(batch, cache)) for _ in range(2))
    log(f"[lm] {cfg.name}: {sum(p.numel() for p in model.parameters())} "
        f"parameters; prefill {b}x{s}: {launches} flash_attention launches, "
        f"finite logits {want_shape}, {ms!r} ms, {b * s / ms * 1e3!r} "
        f"tokens/s, peak memory {peak} B")
    del cache

    errs, peaks = [], []

    def checked(q, k, v, causal=True):
        o = kernel(q, k, v, causal=causal)
        errs.append(compare(torch, o, ref.attention_ref(q, k, v,
                                                        causal=causal),
                            BF16_TOL, f"layer {len(errs)}", quiet=True))
        peaks.append(float((q[0, 0].float() @ k[0, 0].float().T).abs().max())
                     * ref.default_scale(q.shape[-1]))
        return o

    with attention_as(ops, checked) as kernel:
        model.forward(batch)
    layer_err = max(errs)
    log(f"[lm] K2 vs plain on each layer's own inputs ({len(errs)} layers, "
        f"bf16): max_abs_err {layer_err!r} (tolerance {BF16_TOL} abs + "
        f"{BF16_TOL} rel); largest attention logit of batch row 0, head 0: "
        f"{min(peaks)!r} to {max(peaks)!r} over the layers")

    f32 = LM(cfg.scaled(dtype="float32"))
    f32.load_state_dict(model.state_dict())     # the same weights, widened
    got32 = f32.forward(batch)
    with attention_as(ops, ref.attention_ref):
        plain32 = f32.forward(batch)
    err32 = logits_err(torch, got32, plain32, f"prefill {b}x{s} float32: "
                       f"K2 vs plain attention", tol=F32_MODEL_TOL)
    del got32
    with attention_as(ops, ref.attention_ref):
        plain16 = model.forward(batch)
    noise = logits_err(torch, plain16, plain32, f"prefill {b}x{s}: plain "
                       f"attention bf16 vs float32 (bf16's own error)")
    err = logits_err(torch, logits, plain16, f"prefill {b}x{s} bf16: K2 vs "
                     f"plain attention", bound=2 * noise)
    del logits, plain16, plain32
    torch.cuda.empty_cache()
    return model, f32, dict(launches=launches, ms=ms, peak=peak, err=err,
                            err32=err32, layer_err=layer_err)


def phase_dense_decode(torch, model, f32, cfg, SyntheticTokens):
    """``phase_decode`` (teacher-forced decode against forward); then, in
    float32 and in bf16, the cache a ``prefill`` of 4 x 255 tokens fills
    against the one teacher-forcing fills, and the next decode step against
    ``forward`` over all 256 tokens. Float32 within F32_MODEL_TOL; bf16
    within twice bf16's own distance from float32."""
    _, _, noise = phase_decode(torch, model, f32, cfg, SyntheticTokens)
    toks = SyntheticTokens(cfg, seq_len=256, global_batch=4).batch(1)
    toks = toks["tokens"].cuda()
    caches = {}
    for m, dt in ((f32, "float32"), (model, "bf16")):
        forced = m.init_cache(4, 256)
        for t in range(255):
            m.decode_step(forced, toks[:, t:t + 1])
        filled = m.init_cache(4, 256)
        m.prefill(dict(tokens=toks[:, :255]), filled)
        caches[dt] = (forced, filled)
    for key in ("k", "v"):
        f32_forced, f32_filled = (c[key] for c in caches["float32"])
        forced, filled = (c[key] for c in caches["bf16"])
        compare(torch, f32_filled, f32_forced, F32_MODEL_TOL,
                f"prefill's {key} cache vs teacher-forced, 4x255, float32",
                tag="lm")
        own = float((forced.float() - f32_forced).abs().max())
        err = float((filled.float() - forced.float()).abs().max())
        log(f"[lm] prefill's {key} cache vs teacher-forced, 4x255, bf16: "
            f"max_abs_err {err!r} (bound: twice bf16's own {own!r})")
        if not err <= 2 * own:
            fail(f"prefill's {key} cache, bf16, outside the bound")
    for m, dt, rule in ((f32, "float32", dict(tol=F32_MODEL_TOL)),
                        (model, "bf16", dict(bound=2 * noise))):
        filled = caches[dt][1]
        got = m.decode_step(filled, toks[:, 255:])[0]
        want = m.forward(dict(tokens=toks))[:, 255:]
        logits_err(torch, got, want, f"decode_step after prefill(4x255) vs "
                   f"forward(4x256) at the last position, {dt}", **rule)
    del caches
    torch.cuda.empty_cache()


def phase_reference_init(torch, ref, ops, f32, cfg, SyntheticTokens):
    """Why the port's attention init is not the reference's (fault 5). The
    float32 twin's wq, wk, wv and wo, drawn at their fan-ins (d_model, and
    heads x head dim for wo), are rescaled in place to the reference's draw
    (its ``_init`` scales a 4-d draw by 1/sqrt(shape[-2]): the head count
    for wq, wk and wv, the head dim for wo), and the prefill
    logits of K2 and of ``attention_blockwise`` are held against
    ``attention_ref``. The two plain paths differ only in summation order.
    A reading, not a gate; the twin is spent afterwards."""
    b, s = ATTN_MAIN[0], ATTN_MAIN[3]
    batch = SyntheticTokens(cfg, seq_len=s, global_batch=b).batch(0)
    dm, hq, hkv = cfg.d_model, cfg.heads, cfg.kv_heads
    for key, factor in (("wq", dm / hq), ("wk", dm / hkv), ("wv", dm / hkv),
                        ("wo", hq)):
        f32.attn[key].mul_(factor ** 0.5)
    peaks = []

    def plain(q, k, v, causal=True):
        peaks.append(float((q[0, 0] @ k[0, 0].T).abs().max())
                     * ref.default_scale(q.shape[-1]))
        return ref.attention_ref(q, k, v, causal=causal)

    with attention_as(ops, plain):
        want = f32.forward(batch)
    log(f"[lm] reference init, float32: largest attention logit of batch "
        f"row 0, head 0: {min(peaks)!r} to {max(peaks)!r} over the layers")
    what = f"prefill {b}x{s} float32 at the reference's init (seed 0, batch 0)"
    got = f32.forward(batch)
    k2 = logits_err(torch, got, want, f"{what}: K2 vs attention_ref")
    del got
    with attention_as(ops, ref.attention_blockwise):
        got = f32.forward(batch)
    blk = logits_err(torch, got, want, f"{what}: attention_blockwise vs "
                     f"attention_ref (summation order only)")
    del got, want
    torch.cuda.empty_cache()
    return k2, blk


def attn_pairs(s, t, causal):
    """(query row, key column) pairs the function needs: the causal
    triangle with the decode offset, or all."""
    if not causal:
        return s * t
    return sum(max(0, min(t, r + t - s + 1)) for r in range(s))


def phase_attn_timing(torch, FA, ref, rate):
    """K2 at the prefill shape in bf16 (the tensor-core kernel) against its
    bound, its plain version and SDPA. K2 and SDPA are each timed as an
    eager loop of five calls (``ms``, ``library_ms``: the wrapper's host
    work per call included) and as a CUDA graph of five calls
    (``graph_ms``, ``library_graph_ms``: device time only); ``host_ms`` is
    the wrapper's host time per call, 20 calls issued back to back without
    waiting for the card. Then K2 at zamba2-7b's head dim 112 in bf16
    beside SDPA, and the float32 FMA kernel once at the prefill shape,
    against its own bound (the FMA units' 67 TFLOP/s)."""
    b, hq, hkv, s, t, d = ATTN_MAIN
    args = attn_inputs(torch, *ATTN_MAIN, torch.bfloat16, 40)
    o = FA.flash_attention(*args)
    nbytes = sum(x.numel() * x.element_size() for x in args + (o,))
    flops = 4 * d * b * hq * attn_pairs(s, t, True)
    bound_ms = max(nbytes / rate, flops / BF16_PEAK) * 1e3
    bound_by = "bytes" if nbytes / rate >= flops / BF16_PEAK else "operations"
    reps = 5

    def eager_ms(fn):
        return min(cuda_ms(lambda: [fn() for _ in range(reps)])
                   for _ in range(2)) / reps

    def kernel():
        return FA.flash_attention(*args)
    kernel_ms = eager_ms(kernel)
    kernel_graph_ms = graph_ms(torch, kernel, reps)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(20):
        kernel()
    host_ms = (time.perf_counter() - t0) * 1e3 / 20
    torch.cuda.synchronize()
    plain_ms = min(cuda_ms(lambda: ref.attention_ref(*args))
                   for _ in range(2))
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def library():
        return sdpa(*args, is_causal=True, enable_gqa=True)
    lib_err = float((library().float() - o.float()).abs().max())
    library_ms = eager_ms(library)
    library_graph_ms = graph_ms(torch, library, reps)
    log(f"[timing] flash_attention at {ATTN_MAIN} (B, Hq, Hkv, S, T, D), "
        f"bf16, causal: kernel {kernel_ms!r} ms per launch (eager loop of "
        f"{reps}; CUDA graph of {reps}: {kernel_graph_ms!r} ms; the "
        f"wrapper's host time {host_ms!r} ms a call), bound "
        f"{bound_ms!r} ms ({bound_by}: {flops} FLOP at 989 TFLOP/s, "
        f"{nbytes} B at {rate / 1e12:.2f} TB/s), plain {plain_ms!r} ms, "
        f"scaled_dot_product_attention {library_ms!r} ms (eager; CUDA "
        f"graph {library_graph_ms!r} ms; yardstick; "
        f"max |sdpa - kernel| {lib_err!r}); kernel at "
        f"{flops / kernel_ms / 1e9!r} TFLOP/s eager, "
        f"{flops / kernel_graph_ms / 1e9!r} in the graph; "
        f"{bound_ms / kernel_ms!r} / {bound_ms / kernel_graph_ms!r} of its "
        f"bound; {kernel_ms / library_ms!r} times SDPA's time eager, "
        f"{kernel_graph_ms / library_graph_ms!r} in graphs")
    del args, o
    # zamba2-7b's head dim 112 on the D 128 tile (columns 112-127 zero)
    args = attn_inputs(torch, *ZAMBA_ATTN, torch.bfloat16, 42)
    zb, zhq, _, zs, zt, zd = ZAMBA_ATTN
    z_flops = 4 * zd * zb * zhq * attn_pairs(zs, zt, True)
    z_ms = eager_ms(lambda: FA.flash_attention(*args))
    z_sdpa = eager_ms(lambda: sdpa(*args, is_causal=True))
    log(f"[timing] flash_attention at zamba2-7b's {ZAMBA_ATTN}, bf16, "
        f"causal: {z_ms!r} ms per launch (eager loop of {reps}), "
        f"{z_flops / z_ms / 1e9!r} TFLOP/s on the D 112 work, bound "
        f"{z_flops / BF16_PEAK * 1e3!r} ms (operations); "
        f"scaled_dot_product_attention {z_sdpa!r} ms (yardstick)")
    del args
    args = attn_inputs(torch, *ATTN_MAIN, torch.float32, 41)
    f32_ms = min(cuda_ms(lambda: FA.flash_attention(*args))
                 for _ in range(2))
    f32_bound = max(2 * nbytes / rate, flops / FP32_PEAK) * 1e3
    log(f"[timing] flash_attention at {ATTN_MAIN}, float32 (FMA kernel), "
        f"causal: {f32_ms!r} ms per launch, {flops / f32_ms / 1e9!r} "
        f"TFLOP/s; bound on the FMA units {f32_bound!r} ms ({flops} FLOP at "
        f"67 TFLOP/s), {f32_bound / f32_ms!r} of it")
    del args
    torch.cuda.empty_cache()
    return dict(ms=kernel_ms, graph_ms=kernel_graph_ms, host_ms=host_ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=library_ms, library_graph_ms=library_graph_ms,
                f32_ms=f32_ms, d112_ms=z_ms)


def main():
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs a GPU")
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        fail(f"no src/repro_torch beside {__file__}: run it from the repo")
    sys.path.insert(0, SRC)
    import numpy as np
    from repro_torch import api
    from repro_torch.core import topology as T
    from repro_torch.core.simconfig import DeviceConfig, SimConfig
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.device import round_step as rs
    from repro_torch.device import runner
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import ssd_scan as K
    from repro_torch.core import kernelsim as KS
    from repro_torch.launch import serve
    from repro_torch.models.model import LM

    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = card()
    log(f"[card] {name}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    rate = mem_rate(name)

    regs = phase_build(FA, K)
    max_err = phase_kernel_vs_plain(np, torch, rs)
    rounds_err = phase_rounds_vs_plain(np, torch, rs)
    K.launches = FA.launches = 0
    ex, x, lay, launches, subrounds, steps_on_main, secs = phase_main(
        torch, rs, api, T)
    if K.launches or FA.launches:
        fail(f"the broadcast path launched ssd_scan {K.launches} and "
             f"flash_attention {FA.launches} times")
    phase_small(torch, api, T, DeviceConfig, SimConfig)
    tm = phase_timing(np, torch, rs, runner, ex, x, lay, rate, secs)
    moved = tm["bytes"]
    log(f"[main] measure(): {secs * 1e3!r} ms per broadcast (one "
        f"permute_rounds launch, min of 3), {moved} B moved by the kernel = "
        f"{moved / secs / 1e9:.2f} GB/s effective; payload delivered to 255 "
        f"devices = {255 * MAIN_NBYTES / secs / 1e9:.2f} GB/s")
    log(f"[summary] {name}: K1 broadcast {tm['ms']!r} ms in one "
        f"permute_rounds launch ({tm['ms'] / subrounds * 1e3!r} us x "
        f"{subrounds} sub-rounds; barrier-only {tm['barrier_ms']!r} ms; "
        f"bound {tm['bound_ms']!r} ms) against {tm['step_graph_ms']!r} ms "
        f"for {subrounds} permute_step launches in a CUDA graph; "
        f"permute_rounds {regs['permute_rounds']}")
    del ex, x
    torch.cuda.empty_cache()
    K.launches = FA.launches = 0
    cal = phase_calibrate(torch, rs, api, T)
    if K.launches or FA.launches:
        fail(f"the calibration path launched ssd_scan {K.launches} and "
             f"flash_attention {FA.launches} times")
    log(f"[summary] {name}: calibration alpha / beta / rel_err: ring8 "
        f"{cal['ring8']['alpha_s'] * 1e6!r} us / "
        f"{cal['ring8']['beta_bytes_per_s'] / 1e9!r} GB/s / "
        f"{cal['ring8']['rel_err']!r}; mesh2d root 255 "
        f"{cal['mesh2d']['alpha_s'] * 1e6!r} us / "
        f"{cal['mesh2d']['beta_bytes_per_s'] / 1e9!r} GB/s / "
        f"{cal['mesh2d']['rel_err']!r}")

    ec = phase_eventcore(np, torch, rate)
    if K.launches or FA.launches:
        fail(f"the event core's path launched ssd_scan {K.launches} and "
             f"flash_attention {FA.launches} times")
    sw, pl = ec["sweep"], ec["plain"]
    log(f"[summary] {name}: event core {ec['launches']} launches on the "
        f"main path; mesh2d 32x32 srda x {sw['lanes']} lanes "
        f"{sw['ms']!r} ms in one launch ({sw['us_per_step']!r} us a step; "
        f"scan kernel {sw['scan_ms']!r} ms) against {sw['numpy_ms']!r} ms "
        f"for the numpy engine; mesh2d 16x16 srda x {pl['lanes']} lanes "
        f"{pl['ms']!r} ms (scan {pl['scan_ms']!r} ms, plain "
        f"{pl['plain_ms']!r} ms, numpy {pl['numpy_ms']!r} ms); 64x64 glf "
        f"{ec['glf']['ms']!r} ms (scan {ec['glf']['scan_ms']!r}), bine "
        f"{ec['bine']['ms']!r} ms (scan {ec['bine']['scan_ms']!r}, numpy "
        f"{ec['bine']['numpy_ms']!r}), srda {ec['srda']['ms']!r} ms (scan "
        f"{ec['srda']['scan_ms']!r}, numpy {ec['srda']['numpy_ms']!r}); "
        f"step floor {ec['floor_us_per_step']!r} us")
    dist_res = phase_distributed(torch)

    ssd_err = phase_ssd_vs_plain(torch, K, ref)
    cfg = get_config("mamba2-370m")
    FA.launches = 0
    model, f32, pf = phase_prefill(torch, K, rs, ref, ops, cfg, LM,
                                   SyntheticTokens)
    if FA.launches:
        fail(f"the Mamba-2 prefill launched flash_attention {FA.launches} "
             f"times")
    phase_decode(torch, model, f32, cfg, SyntheticTokens)
    del f32
    torch.cuda.empty_cache()
    phase_serve(torch, serve, cfg)
    st = phase_ssd_timing(torch, K, ref, rate)
    dec = phase_decode_timing(torch, model, serve, SyntheticTokens, cfg)
    phase_profile(torch, model, cfg, SyntheticTokens)
    log(f"[summary] {name}: K3 {st['ms']!r} ms per launch (eager; "
        f"{st['graph_ms']!r} ms in a CUDA graph; float32 FMA kernel "
        f"{st['f32_ms']!r} ms) x {pf['launches']} "
        f"launches per prefill; prefill 4x2048 {pf['ms']!r} ms "
        f"({4 * 2048 / pf['ms'] * 1e3!r} tokens/s), peak {pf['peak']} B; "
        f"decode {dec['step_ms']!r} ms per step; serve {dec['tok_per_s']!r} "
        f"tok/s")
    del model
    torch.cuda.empty_cache()

    attn_err = phase_attn_vs_plain(torch, FA, ref)
    dcfg = get_config("llama3.2-3b")
    dense, d32, dpf = phase_dense_prefill(torch, FA, K, rs, ref, ops, dcfg,
                                          LM, SyntheticTokens)
    phase_dense_decode(torch, dense, d32, dcfg, SyntheticTokens)
    phase_reference_init(torch, ref, ops, d32, dcfg, SyntheticTokens)
    del d32
    torch.cuda.empty_cache()
    phase_serve(torch, serve, dcfg)
    at = phase_attn_timing(torch, FA, ref, rate)
    ddec = phase_decode_timing(torch, dense, serve, SyntheticTokens, dcfg)
    phase_profile(torch, dense, dcfg, SyntheticTokens)
    log(f"[summary] {name}: K2 {at['ms']!r} ms per launch (eager; "
        f"{at['graph_ms']!r} ms in a CUDA graph) x {dpf['launches']} "
        f"launches per prefill (bound {at['bound_ms']!r} ms, sdpa "
        f"{at['library_ms']!r} ms eager, {at['library_graph_ms']!r} ms in a "
        f"graph; float32 FMA kernel "
        f"{at['f32_ms']!r} ms); llama3.2-3b prefill 4x2048 "
        f"{dpf['ms']!r} ms ({4 * 2048 / dpf['ms'] * 1e3!r} tokens/s), peak "
        f"{dpf['peak']} B; decode {ddec['step_ms']!r} ms per step; serve "
        f"{ddec['tok_per_s']!r} tok/s")
    kernels = [{
        "name": "permute_rounds", "route": "cuda",
        "source": "src/repro_torch/csrc/permute_rounds.cu",
        "replaces": "src/repro/device/pallas_step.py:46",
        "launches": launches, "subrounds": subrounds,
        "max_abs_err": rounds_err,
        "ms": tm["ms"], "plain_ms": tm["plain_ms"],
        "bound_ms": tm["bound_ms"], "bound_by": "bytes",
        "library_ms": tm["library_ms"], "barrier_ms": tm["barrier_ms"],
        "host_ms": tm["host_ms"], "old_graph_ms": tm["step_graph_ms"],
        "blocks": tm["blocks"], "threads": tm["threads"],
        **regs["permute_rounds"],
    }, {
        # the one-sub-round kernel: the main path no longer launches it
        # (launches 0); timed per launch over the same sub-rounds
        "name": "permute_step", "route": "cuda",
        "source": "src/repro_torch/csrc/permute_step.cu",
        "replaces": "src/repro/device/pallas_step.py:46",
        "launches": steps_on_main, "max_abs_err": max_err,
        "ms": tm["step_ms"], "plain_ms": tm["step_plain_ms"],
        "bound_ms": tm["step_bound_ms"], "bound_by": "bytes",
        "library_ms": tm["step_library_ms"],
        "eager_ms": tm["step_eager_ms"], "timed_launches": tm["subrounds"],
    }, {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:30",
        "launches": dpf["launches"], "max_abs_err": attn_err,
        "ms": at["ms"], "plain_ms": at["plain_ms"],
        "bound_ms": at["bound_ms"], "bound_by": at["bound_by"],
        "library_ms": at["library_ms"], "graph_ms": at["graph_ms"],
        "library_graph_ms": at["library_graph_ms"],
        "host_ms": at["host_ms"], "d112_ms": at["d112_ms"],
    }, {
        "name": "ssd_scan", "route": "cuda",
        "source": "src/repro_torch/csrc/ssd_scan.cu",
        "replaces": "src/repro/kernels/ssd_scan.py:30",
        "launches": pf["launches"], "max_abs_err": ssd_err,
        "ms": st["ms"], "plain_ms": st["plain_ms"],
        "bound_ms": st["bound_ms"], "bound_by": st["bound_by"],
        "library_ms": None, "graph_ms": st["graph_ms"],
        "host_ms": st["host_ms"], "tflops": st["tflops"],
        "share_of_bound": st["share_of_bound"], "f32_ms": st["f32_ms"],
    }, {
        # ms, scan_ms, plain_ms, numpy_ms and bound_ms at the lanes held
        # against the plain version (mesh2d 16 x 16 srda, 12 sizes);
        # "sweep" (mesh2d 32 x 32 srda, 12 sizes), "glf", "bine" and "srda"
        # (mesh2d 64 x 64, one lane) the other shapes of the main path;
        # floor_us_per_step the design's step on a chain of tasks
        "name": "event_core", "route": "cuda",
        "source": "src/repro_torch/csrc/event_core.cu",
        "replaces": "src/repro/core/kernelsim.py:121",
        "launches": ec["launches"], "mismatches": pl["mismatches"],
        "max_abs_err": pl["max_abs_err"],
        "ms": pl["ms"], "scan_ms": pl["scan_ms"], "plain_ms": pl["plain_ms"],
        "numpy_ms": pl["numpy_ms"], "bound_ms": pl["bound_ms"],
        "bound_by": "bytes", "limited_by": "latency of 2n dependent steps",
        "library_ms": None, "steps": pl["steps"], "lanes": pl["lanes"],
        "tasks": pl["tasks"],
        "floor_us_per_step": ec["floor_us_per_step"],
        **{key: {k: ec[key][k] for k in (
            "tasks", "lanes", "steps", "ms", "us_per_step", "scan_ms",
            "scan_us_per_step", "variants_ms", "prep_ms", "memory", "numpy_ms",
            "bound_ms")} for key in ("sweep", "glf", "bine", "srda")},
        **regs["event_core"],
    }, {
        # the scan design, the kernel's first form: the main path no longer
        # launches it
        # (launches 0); timed in turns with event_core on the same shapes
        "name": "event_core_scan", "route": "cuda",
        "source": "src/repro_torch/csrc/event_core_scan.cu",
        "replaces": "src/repro/core/kernelsim.py:121",
        "launches": ec["scan_launches"], "max_abs_err": pl["scan_err"],
        "ms": pl["scan_ms"], "plain_ms": pl["plain_ms"],
        "bound_ms": pl["bound_ms"], "bound_by": "bytes",
        "library_ms": None,
        **{key: ec[key]["scan_ms"] for key in ("sweep", "glf", "bine",
                                                "srda")},
        **regs["event_core_scan"],
    }]
    log(f"[summary] the whole run took {time.perf_counter() - t_start:.1f} s "
        f"after the imports")
    print(json.dumps({"calibration": cal}), flush=True)
    print(json.dumps({"distributed": dist_res}), flush=True)
    print(name, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
