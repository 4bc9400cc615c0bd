#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which exits non-zero on failure:

1. build every CUDA kernel of the main paths with ``nvcc`` (sm_90a), all
   sources at once: ``permute_rounds`` (K1, every sub-round of a broadcast
   in one persistent launch), ``permute_step`` (K1's one-sub-round kernel,
   the yardstick), ``unpack_rows`` (UR, the runner's copy out, and in the
   same library ``fill_inplace``, the in-place layout's start),
   ``flash_attention`` (K2), ``ssd_scan`` (K3) and
   ``event_core`` (EC); print
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
   path's buffer over 2**32 bytes, two launches bit-identical, and the same
   moves by dependency phase;
3. the broadcast path: ``repro_torch.api.compile(mesh2d(16, 16)).executable(
   root=0, nbytes=16 MiB)`` on cuda -- 256 virtual devices, verified bit-exact
   on every device, in exactly one ``permute_rounds`` launch running d x
   cycles sub-rounds, no ``permute_step`` launch, in the runner's in-place
   layout (K1 writes into the stacked output) with one ``fill_inplace``
   launch and one ``unpack_rows`` launch a broadcast for its tail (in
   ``verify`` and in ``run``); then on that placement, on random
   allocations, ``fill_inplace`` byte-equal to ``fill_ref``, K1 at the
   placement's byte offsets to ``permute_rounds_ref`` over its first 64
   sub-rounds and, by dependency phase, over all of them, and
   ``unpack_tail`` to ``tail_ref``; the plan's phases beside its
   sub-rounds;
4. small broadcasts (ring 8, hypercube 3; bbs and bine_tree; roots 0 and 3;
   bfloat16) on the card, each verified and held against the CPU run;
5. K1's timing at the broadcast's shape: the old design per launch (a CUDA
   graph of the 2,156 ``permute_step`` launches, so host launch cost is
   left out; and their eager loop), the new one (``measure()``: one
   ``permute_rounds`` launch a broadcast by phase, min of 3; the same
   launch a step a sub-round; its barrier-only time, a launch of the
   sub-rounds with every count 0; the copy loop's TB/s on the plan's
   largest phase alone; the wrapper's host time; these on the in-place
   allocation), the bound (bytes moved over the card's memory
   rate), the plain versions and the ``index_select``/``index_copy_``
   yardstick; then the main path's ``unpack_tail`` and ``fill_inplace``
   held and timed on its placement against ``tail_ref`` and ``fill_ref``,
   a flat ``copy_`` and their bounds (the ``kernels`` line's UR and fill
   entries); then UR's staged copy out held byte for byte against
   ``unpack_ref`` on random buffers (padding bytes random too) at the
   main path's layout staged and at two of the benchmark cells' 128e6 B
   layouts on 256 devices (mesh2d root 17 and dragonfly root 0, rows of
   used % 16 = 8 and 4), one launch each; at each, UR's time (CUDA events,
   min of 3), ``unpack_ref``'s, the strided ``copy_`` into a held output
   (the library yardstick), a flat ``copy_`` of as many bytes (the
   ceiling) and the bound (2 x n x nbytes bytes over the memory rate);
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
   rows) and srda (its largest list, 53,247 tasks); then on those shapes
   and on mesh2d 16 x 16 srda in 12 lanes the kernel's results, in both
   memory variants where the shared one fits, bit-exact against
   ``event_core_ref`` on the card where that takes under about 30 s, else
   the global variant against the shared one; each shape's time (CUDA
   events) in each variant, time a step, the compaction's time, the numpy
   engine's time on the same lists and the bytes bound; and the step floor
   of the design: the kernel on a chain of tasks, one private resource
   each;
8. the distributed executor (``repro_torch.device.distributed``) over
   ``min(8, device_count)`` NCCL ranks, one GPU each, bit for bit against
   the virtual mesh, when the machine has two GPUs or more; then, across
   those ranks, ``calibrate(ring(world), group=WORLD)`` at the ring ladder
   (the same cost on every rank, the ring delivered, alpha >= 0, beta > 0,
   ``cuda-nccl`` and not emulated, one ``permute_step`` launch a ring
   sub-round on each rank), the artifact stored under its group key and
   reloaded equal, and ``prediction_report`` of BBS, ``binomial`` and
   ``pipeline`` at 4 and 16 MiB on ``ring(world)`` (and ``mesh2d(2, world
   / 2)`` at 4 or 8 ranks), each verified on every rank, predicted and
   measured finite and positive; alpha, beta, each size's round and each
   row's times and ``rel_err`` are readings; on one GPU a line says it
   was not run and why;
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
   the float32 FMA kernel once at the same shape; K2 at the other
   families' shapes (llava-next-mistral-7b's causal (4, 32, 16, 2304, 2304,
   128); seamless-m4t-large-v2's non-causal (4, 16, 16, S, 2048, 64) for
   S = 2048 and S = 1) beside SDPA and its bound; prefill time, decode time
   after a 4 x 2048 prefill, serve's tokens/s; a ``torch.profiler`` window
   over one dense prefill and the four decode steps after it;
15-18. the serving paths of the other four families at full width (random
   weights from seed 0), one model at a time, each freed before the next
   (``phase_family``): llava-next-mistral-7b (vlm: 256 patches before the
   tokens), granite-moe-1b-a400m (moe), zamba2-7b (hybrid) and
   seamless-m4t-large-v2 (encdec: 2048 frames beside the tokens).
   ``LM.prefill`` of 4 x 2048 ``SyntheticTokens`` with exactly the K2 and
   K3 launches of ``FAMILIES`` and none of K1 or EC, finite logits, the
   cache filled; K2 and K3 against their plain versions on the first and
   the last launch of each kind; the bf16 prefill within twice bf16's own
   distance from a float32 twin (zamba2-7b's twin cut to 12 of its 81
   blocks, and the bf16 model with it); teacher-forced ``decode_step``
   against ``forward`` over 4 x 64 tokens in both dtypes (the moe on twins
   whose capacity drops no token); for vlm, moe and encdec a decode step
   after a ``prefill``-filled cache against ``forward``; prefill time (min
   of 2), decode time a step, peak memory, a ``torch.profiler`` window
   over one prefill and over two decode steps; ``serve.main --arch <id>
   --prompt-len 8 --tokens 16``. Phases 12 and 9 hold K2 and K3 at these
   models' new shapes (K2 non-causal at S = 2048 and S = 1 against
   T = 2048, K2 at llava's 2304, K3 at zamba2-7b's (4, 2048, 56, 128,
   64));
19. ``[train]``, the training path (``runtime.steps``, ``optim.adamw``,
   ``checkpoint.store``, ``runtime.supervisor``, ``launch.train``): K2
   and K3 through their autograd Function (``kernels.grad.KernelGrad``:
   the kernel forward, the plain version's backward) at llama3.2-3b's
   prefill (4, 32, 16, 2048, 2048, 128) and training (8, 32, 16, 128,
   128, 128) shapes, a non-causal S != T shape, Mamba-2's and zamba2-7b's
   prefill shapes and the overflow regime: one counted launch each, input
   gradients bit-equal to autograd through the plain version, finite;
   ``LM.loss`` and its backward for llama3.2-3b and mamba2-370m at 8 x 128,
   full width and depth, through the kernels (28 K2 / 48 K3 launches) and
   through the plain versions, in bf16 and on the float32 twin (the twin's
   paths within 1e-3; each bf16 gradient within twice bf16's own distance
   from the twin's); eight ``make_train_step`` steps of llama3.2-3b at
   8 x 128, lr 1e-3 (a finite, falling loss; exactly 28 K2 launches a step
   and none of K3, K1 or EC; ms a step, peak memory), two microbatches
   against one from the same parameters (loss and grad norm within 1e-2),
   a ``torch.profiler`` window over one step split into GEMMs, K2, the
   plain attention backward, AdamW and other; and ``launch.train.main``
   for mamba2-370m (12 steps, a checkpoint every 6: a falling loss,
   exactly 48 K3 launches a step, the step-6 checkpoint restored bit-equal
   to the state it saved, a fresh supervisor resuming from step 12 with no
   step run, steps 7-12 rerun from step 6 within 1e-3 of the first run's
   losses; seconds a save and a restore; the directory removed);
20. ``[sharded]``, the training step on a mesh (``runtime.sharding``,
   ``runtime.steps`` on DTensors): llama3.2-3b at full width and depth,
   8 x 128, lr 1e-3, in one spawned NCCL rank on a 1 x 1 ``("data",
   "model")`` mesh, three ``make_train_step`` steps with params, moments
   and batches placed by ``param_shardings``, ``opt_shardings`` and
   ``batch_shardings``, then (the sharded run freed, its final parameters
   on the host) the same three steps unsharded from the same weights:
   losses, grad norms and every final parameter bit-equal, exactly 28 K2
   launches a sharded step and none of K3, K1 or EC; ms a step of both,
   the DTensor path's overhead, peak memory, the bytes of params, moments
   and batch as allocated; one more unsharded step under
   ``torch.profiler`` with ``with_flops``. With two GPUs or more,
   ``(count // 2, 2)`` NCCL ranks run the sharded steps too, their losses
   within 1e-2 of the one-device losses; on one GPU a line says that part
   was not run;
21. ``[dryrun]``: three ``python -m repro_torch.launch.dryrun``
   subprocesses, CPU only (CUDA hidden), started when the script starts
   and read here: llama3.2-3b ``train_4k`` on the 16 x 16 fake mesh,
   mamba2-370m ``train_4k --multi-pod`` (2 x 16 x 16), and the
   ``[sharded]`` cell (1 x 1, llama3.2-3b, 8 x 128 train); each record
   printed; the ``[sharded]`` cell's ``argument_bytes`` equal to the
   bytes the card allocated for params, moments and batch, its ``flops``
   less K2's formula within 1e-3 of the profiler's matmul FLOPs of the
   same step, its ``peak_bytes`` printed beside the card's
   ``max_memory_allocated``.

The last lines are one JSON line with the calibration readings, one with
the distributed phase's (null on one GPU), one with the families'
readings, one with the training section's, one with the sharded and
dry-run phases' (``{"sharded": ..., "dryrun": ...}``), the card
(``nvidia-smi`` name and power limit), one JSON line with every kernel, and
``{"ok": true, "device": {...}}``. Without a
GPU, or without the repo beside it, it exits non-zero and prints no result.
"""

import atexit
import contextlib
import dataclasses
import ctypes
import json
import math
import os
import re
import subprocess
import sys
import tempfile
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
# K2 at the other families' shapes (B, Hq, Hkv, S, T, D, causal): the
# llava-next-mistral-7b prefill (256 patches + 2048 tokens), and
# seamless-m4t-large-v2's non-causal attention (its encoder, its
# cross-attention at a 4 x 2048 prefill, and its decode's cross-attention,
# one query row against the 2048 encoder states)
NEW_ATTN = (("llava-next-mistral-7b prefill", (4, 32, 16, 2304, 2304, 128),
             True),
            ("seamless-m4t-large-v2 encoder / cross-attention",
             (4, 16, 16, 2048, 2048, 64), False),
            ("seamless-m4t-large-v2 decode cross-attention",
             (4, 16, 16, 1, 2048, 64), False))
# K3 at the zamba2-7b prefill: batch, sequence, heads, head dim, state
ZAMBA_SSD = (4, 2048, 56, 128, 64)
# the calibration cells: ring 8 at 4 MiB with the reference bench cell's
# ladder, iters and reps (benchmarks/simbench.py, device_collective); mesh2d
# 16 x 16 at 16 MiB from root 255 (root 0's orbit) at the default ladder
CAL_RING_NBYTES = 4 << 20
CAL_RING_SIZES = (8 << 10, 64 << 10, 256 << 10, 1 << 20)
CAL_SIZES = (1 << 10, 8 << 10, 64 << 10, 256 << 10, 1 << 20)
CAL_ITERS, CAL_REPS = 32, 5
# K1 held on the main path's placement over its first sub-rounds (the plain
# version is a Python loop over sub-rounds)
MAIN_PREFIX = 64
# UR at two of the benchmark cells' 128e6 B layouts on 256 devices
# (runner.packet_layout on their float32 plans): (total, used, row_bytes,
# nbytes); used % 16 is 8 and 4, so no output row starts on the 16-byte grid
UNPACK_SHAPES = (("mesh2d-256 root 17", (2550, 50200, 50208, 128_000_000)),
                 ("dragonfly-256 root 0", (3870, 33076, 33088, 128_000_000)))
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
    names = ["permute_rounds", "permute_step", "unpack_rows",
             "flash_attention", "ssd_scan", "event_core"]
    nvcc.build(names)
    log(f"[build] {', '.join(names)} built in "
        f"{time.perf_counter() - t0:.3f} s")
    k1 = {}
    # (the library, the kernel's name): a kernel in an anonymous namespace
    # has its file's name in its mangled name
    for src, kernel in (("permute_rounds", "permute_rounds"),
                        ("permute_step", "permute_step"),
                        ("unpack_rows", "unpack_rows_kernel"),
                        ("unpack_rows", "fill_inplace_kernel")):
        (_, r, st, ld, _), = ptxas_kernels(nvcc.build_log(src), kernel)
        log(f"[build]   {src} {kernel}: {r} registers, spill stores {st} B, "
            f"spill loads {ld} B")
        k1[kernel.replace("_kernel", "")] = dict(
            registers=r, spill_stores=st, spill_loads=ld)
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
    group_path_vs_plain(torch, rs)
    return worst


def group_path_vs_plain(torch, rs):
    """``permute_step`` against ``permute_step_ref`` at the distributed
    executor's shapes (``repro_torch.device.distributed``): one rank's
    ``[1, rows + 1, row]`` buffer with K1's tables of its writes
    (``local_writes``), for the calibration ring at every size of
    ``CAL_RING_SIZES`` and for every rank of the 16 MiB BBS, ``binomial``
    and ``pipeline`` broadcasts on ring 4 and mesh2d 2 x 2. The buffer
    starts random; before each of the writes ``distributed.run`` makes, the
    staging row gets fresh random bytes, as a receive gives it; the whole
    buffer is held bit-exact after every write."""
    import importlib
    from repro_torch import api
    from repro_torch.core import topology as T
    from repro_torch.core.simconfig import DeviceConfig, SimConfig
    from repro_torch.device import distributed as D
    from repro_torch.device import runner
    C = importlib.import_module("repro_torch.device.calibrate")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(5)

    def check(rows, row_bytes, tabs, what):
        local = D.local_writes(tabs, rows)
        got = torch.randint(0, 256, (1, rows + 1, row_bytes),
                            dtype=torch.uint8, device=dev, generator=g)
        ref = got.clone()
        tab = torch.from_numpy(local).to(dev)
        writes = [k for k in range(len(local)) if local[k, 4, 0]]
        for k in writes:
            fresh = torch.randint(0, 256, (row_bytes,), dtype=torch.uint8,
                                  device=dev, generator=g)
            got[0, rows] = fresh
            ref[0, rows] = fresh
            rs.permute_step_ref(ref, tab[k])
            rs.permute_step(got, tab[k])
            if not torch.equal(got, ref):
                fail(f"kernel differs from plain version: {what}, "
                     f"sub-round {k}, by up to "
                     f"{max_byte_diff(torch, got, ref)}")
        return len(writes)

    for size in CAL_RING_SIZES:
        row = C.ring_row_bytes(size)
        tabs, _ = D.ring_tables(1, 4, CAL_ITERS)
        k = check(2, row, tabs, f"group ring {size} B")
        log(f"[kernel] bit-exact: group calibration ring, [1, 3, {row}] "
            f"buffer, {k} writes")
    cfg = SimConfig(device=DeviceConfig(device="cuda"))
    for fabric in (T.ring(4), T.mesh2d(2, 2)):
        model = api.compile(fabric)
        for algo in ("bbs", "binomial", "pipeline"):
            ex = model.executable(root=0, nbytes=DIST_NBYTES, algo=algo,
                                  config=cfg)
            lay = runner.packet_layout(ex.default_payload(), ex.schedule,
                                       ex.num_groups)
            k = sum(check(lay.rows, lay.row_bytes,
                          D.bbs_tables(ex.schedule, ex.num_groups, me)[0],
                          f"{fabric.name} {algo} rank {me}")
                    for me in range(fabric.num_nodes))
            log(f"[kernel] bit-exact: group {fabric.name} {algo} "
                f"{DIST_NBYTES} B, [1, {lay.rows + 1}, {lay.row_bytes}] "
                f"buffers of {fabric.num_nodes} ranks, {k} writes")
    torch.cuda.empty_cache()


def phase_rounds_vs_plain(np, torch, rs):
    """``permute_rounds`` (every sub-round in one launch) against
    ``permute_rounds_ref`` on the card, bit-exact. Returns the largest byte
    difference seen (0 when bit-exact)."""
    dev = torch.device("cuda")
    rng = np.random.default_rng(12)
    worst = 0

    def check(buf, tabs, what, s0=0, s1=None):
        nonlocal worst
        host = rs.compact_moves(tabs, buf.shape[1])
        moves = host.to(dev)
        want = rs.permute_rounds_ref(buf.clone(), moves, s0, s1)
        got = rs.permute_rounds(buf.clone(), moves, s0, s1)
        again = rs.permute_rounds(buf.clone(), moves, s0, s1)
        # the same moves by dependency phase (a whole range runs by phase)
        phased = rs.with_phases(host, buf.shape[2]).to(dev)
        by_phase = rs.permute_rounds(buf.clone(), phased, s0, s1)
        torch.cuda.synchronize()
        worst = max(worst, max_byte_diff(torch, got, want),
                    max_byte_diff(torch, by_phase, want))
        if not torch.equal(got, want):
            fail(f"permute_rounds differs from plain version: {what}")
        if not torch.equal(again, got):
            fail(f"two permute_rounds launches differ: {what}")
        if not torch.equal(by_phase, want):
            fail(f"permute_rounds by phase differs from plain version: "
                 f"{what}")
        idle = int((moves.counts[s0:s1] == 0).sum())
        steps = phased.phases.count if phased.phases and s1 is None \
            else "no"
        log(f"[rounds] bit-exact, two launches identical, by phase too "
            f"({steps} phases): {what} ({idle} sub-rounds of count 0)")
        del want, got, again, by_phase

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
    from repro_torch.device import runner
    rs.launches = rs.rounds_launches = rs.subrounds = rs.phases = 0
    runner.unpack_launches = runner.inplace_runs = runner.fill_launches = 0
    t0 = time.perf_counter()
    chk = ex.verify(x)
    torch.cuda.synchronize()
    t_verify = time.perf_counter() - t0
    launches, subrounds, steps = rs.rounds_launches, rs.subrounds, \
        rs.launches
    phases = rs.phases
    unpacks = runner.unpack_launches
    out = ex.run(x)
    plc = ex.lowered.placement(x)
    lay = plc.lay
    if not plc.inplace or runner.inplace_runs != 2:
        fail(f"main path took the in-place layout {runner.inplace_runs} "
             f"times in 2 broadcasts (in place: {plc.inplace})")
    tails = int(plc.tail > 0)          # the tail copy, if a row straddles
    if unpacks != tails or runner.unpack_launches != 2 * tails:
        fail(f"main path launched unpack_rows {unpacks} times in verify and "
             f"{runner.unpack_launches - unpacks} in run, expected {tails} a "
             f"broadcast")
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
    moves = ex.moves()
    if moves.phases is None or phases != plc.at.num_phases or \
            not phases < subrounds:
        fail(f"main path ran {phases} steps for {subrounds} sub-rounds, "
             f"expected its {plc.at.num_phases} dependency phases")
    if runner.fill_launches != 2:
        fail(f"main path launched fill_inplace {runner.fill_launches} times "
             f"in 2 broadcasts, expected 1 a broadcast")
    held = main_layout_vs_plain(torch, rs, runner, ex.moves(), plc, x,
                                ex.root)
    secs = ex.measure(x, reps=3)
    log(f"[main] mesh2d 16x16, {MAIN_NBYTES} B float32 from root 0: "
        f"candidate {ex.candidate}, K={s.K}, m={ex.num_groups}, d={s.d}, "
        f"cycles={s.num_cycles(ex.num_groups)}, relay rows={s.num_relay}, "
        f"{launches} permute_rounds launch for {subrounds} sub-rounds in "
        f"{phases} dependency phases (the largest "
        f"{int((moves.phases.offs[1:] - moves.phases.offs[:-1]).max())} "
        f"moves), "
        f"{int(moves.counts.sum())} row moves, in place: "
        f"{plc.full} rows a device in the output, {plc.scratch} in "
        f"scratch, a tail of {plc.tail} B; {unpacks} unpack_rows launch a "
        f"broadcast; allocation {plc.alloc_bytes} B (staged buffer "
        f"{lay.buffer_bytes} B: {lay.rows} rows x {lay.row_bytes} B x "
        f"{lay.n} devices)")
    log(f"[main] plan+tables build {t_build:.3f} s; verify (run + compare) "
        f"{t_verify:.3f} s; ok on all {len(chk.required)} devices")
    log(f"[main] on the main path's placement, random allocations of "
        f"{plc.alloc_bytes} B: fill_inplace byte-equal to fill_ref, K1 on "
        f"its byte offsets to permute_rounds_ref over sub-rounds "
        f"[0, {held['subrounds']}) and by phase over all {subrounds}, "
        f"unpack_tail to tail_ref")
    return ex, x, lay, plc, launches, subrounds, steps, unpacks, secs


def main_layout_vs_plain(torch, rs, runner, moves, plc, x, root):
    """The main path's three in-place launches, each against its plain
    version on the main path's placement, byte for byte, on random
    allocations (so no byte is right by chance): ``fill_inplace`` against
    ``fill_ref``, K1 at the placement's byte offsets (``plc.at``) against
    ``permute_rounds_ref`` over the first ``MAIN_PREFIX`` sub-rounds (a
    step a sub-round) and over all of them (by phase), and ``unpack_tail``
    against ``tail_ref``."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(29)

    def rand():
        return torch.randint(0, 256, (plc.alloc_bytes,), dtype=torch.uint8,
                             device=dev, generator=g)

    def held(what, got, want):
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            fail(f"[main] {what}: {int((got != want).sum())} bytes differ "
                 f"from the plain version")

    alloc = rand()
    want = alloc.clone()
    runner.fill_ref(want, x.reshape(-1).view(torch.uint8), plc, root)
    runner.fill_inplace(alloc, x, plc, root)
    held("fill_inplace", alloc, want)
    s1 = min(MAIN_PREFIX, moves.num_subrounds)
    rs.permute_rounds_ref(want, moves, 0, s1, at=plc.at)
    rs.permute_rounds(alloc, moves, 0, s1, at=plc.at)
    held(f"K1 on the placement's offsets, sub-rounds [0, {s1})", alloc, want)
    del alloc, want
    alloc = rand()
    want = rs.permute_rounds_ref(alloc.clone(), moves, at=plc.at)
    rs.permute_rounds(alloc, moves, at=plc.at)
    held(f"K1 on the placement's offsets by phase, all "
         f"{moves.num_subrounds} sub-rounds", alloc, want)
    del alloc, want
    alloc = rand()
    want = alloc.clone()
    runner.tail_ref(want, plc)
    before = runner.unpack_launches
    runner.unpack_tail(alloc, plc)
    if runner.unpack_launches != before + int(plc.tail > 0):
        fail(f"[main] unpack_tail launched unpack_rows "
             f"{runner.unpack_launches - before} times")
    held("unpack_tail", alloc, want)
    del alloc, want
    torch.cuda.empty_cache()
    return dict(subrounds=s1)


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


def phase_timing(np, torch, rs, runner, ex, x, lay, plc, rate, secs):
    """K1 over the main path's whole cycle loop, both designs on one card:
    the old one launch per sub-round (``permute_step`` in a CUDA graph and
    in an eager loop, per launch), the new one launch per broadcast
    (``measure()``'s ``secs``, by dependency phase; the same launch a step a
    sub-round; the same sub-rounds with every count 0, the barriers alone;
    the plan's largest phase alone, the copy loop's rate; the wrapper's
    host time), the bytes
    bound, the plain versions and the ``index_select``/``index_copy_``
    yardstick. The new design's readings are taken where the main path
    runs it, on the in-place allocation at the placement's byte offsets
    (``plc``); the old design's and the yardstick's, which index the
    ``[n, rows, row_bytes]`` buffer, on the staged buffer."""
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

    low = ex.lowered
    with low.launching() as stream:
        alloc = low.start(x, plc, stream)
    idle = moves.idle()
    idle_at = rs.RowOffsets(plc.at.pairs[:0], plc.at.row_bytes, plc.at.span)
    barrier_ms = min(cuda_ms(lambda: rs.permute_rounds(alloc, idle,
                                                       at=idle_at))
                     for _ in range(3))
    by_sub = dataclasses.replace(moves, phases=None)
    subround_ms = min(cuda_ms(lambda: rs.permute_rounds(alloc, by_sub,
                                                        at=plc.at))
                      for _ in range(3))
    # the copy loop on the plan's largest phase alone: one step
    ph = moves.phases
    big = int(np.argmax(np.diff(ph.offs)))
    pick = ph.order[ph.offs[big]:ph.offs[big + 1]]
    one = plc.at.pairs[pick]
    one_moves = dataclasses.replace(
        moves, pairs=moves.pairs[pick],
        offs=torch.tensor([0, len(one)], device=dev),
        counts=np.array([len(one)]), moves_cum=np.array([0, len(one)]),
        zeros_cum=np.array([0, int((one[:, 1] < 0).sum())]),
        relay_cum=np.zeros(2, dtype=np.int64),
        relay_zeros_cum=np.zeros(2, dtype=np.int64), phases=None)
    one_at = rs.RowOffsets(one, plc.at.row_bytes, plc.at.span)
    one_bytes = one_moves.moved_bytes(0, 1, plc.at.row_bytes)
    one_ms = min(cuda_ms(lambda: rs.permute_rounds(alloc, one_moves,
                                                   at=one_at))
                 for _ in range(5))
    reps = 10
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        rs.permute_rounds(alloc, moves, at=plc.at)
    host_ms = (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize()
    rounds_plain_ms = cuda_ms(lambda: rs.permute_rounds_ref(alloc, moves,
                                                            at=plc.at))
    del alloc
    torch.cuda.empty_cache()

    buf = runner.pack(x, lay, ex.root, dev)
    step_graph_ms = graph_ms(torch, lambda: [rs.permute_step(buf, t)
                                             for t in flat_tabs], 1)
    step_eager_ms = min(cuda_ms(lambda: [rs.permute_step(buf, t)
                                         for t in flat_tabs])
                        for _ in range(2))
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
        f"({nbytes} B at {rate / 1e12:.2f} TB/s), in {ph.count} dependency "
        f"phases; a step a sub-round {subround_ms!r} ms; barrier-only "
        f"({nl} sub-rounds, every count 0) {barrier_ms!r} ms, "
        f"{barrier_ms / nl * 1e3!r} us a sub-round; its largest phase alone "
        f"({len(one)} moves, {one_bytes} B) {one_ms!r} ms, "
        f"{one_bytes / one_ms / 1e9!r} TB/s; "
        f"the wrapper's host time {host_ms!r} ms a call; plain "
        f"(permute_rounds_ref) {rounds_plain_ms!r} ms; all on the in-place "
        f"allocation; {runs} runs of conflict-free consecutive sub-rounds")
    log(f"[timing] permute_step (the old design, {nl} launches, on the "
        f"staged buffer): "
        f"{step_graph_ms!r} ms in a CUDA graph ({step_graph_ms / nl * 1e3!r} "
        f"us a launch), {step_eager_ms!r} ms in an eager loop "
        f"({step_eager_ms / nl * 1e3!r} us a launch); plain "
        f"(permute_step_ref) {step_plain_ms!r} ms; index_select + "
        f"index_copy_ {library_ms!r} ms; permute_rounds takes "
        f"{ms / step_graph_ms!r} of the graph's time")
    return dict(ms=ms, barrier_ms=barrier_ms, host_ms=host_ms,
                phases=ph.count, subround_ms=subround_ms,
                phase_tbps=one_bytes / one_ms / 1e9,
                plain_ms=rounds_plain_ms, bound_ms=bound_ms, bytes=nbytes,
                library_ms=library_ms, blocks=blocks, threads=threads,
                step_ms=step_graph_ms / nl, step_graph_ms=step_graph_ms,
                step_eager_ms=step_eager_ms / nl,
                step_plain_ms=step_plain_ms / nl,
                step_library_ms=library_ms / nl,
                step_bound_ms=bound_ms / nl, subrounds=nl,
                conflict_free_runs=runs)


MAIN_TAIL = "mesh2d 16x16 main path tail"
MAIN_FILL = "mesh2d 16x16 main path fill"


def best_ms(fn, reps=3):
    """The least of ``reps`` CUDA-event timings of one call of ``fn``."""
    return min(cuda_ms(fn) for _ in range(reps))


def phase_inplace_copies(torch, runner, plc, root, rate):
    """The main path's two in-place launches of ``csrc/unpack_rows.cu`` on
    its placement ``plc``, on random allocations, byte-equal to their plain
    versions and timed (CUDA events, min of 3) against them, a flat
    ``copy_`` of as many bytes and the bound, their bytes at the card's
    memory rate: ``unpack_tail`` (each device's tail at a pitch; 2 x n x
    tail bytes; the plain version ``tail_ref`` is one strided ``copy_``,
    the library yardstick too) and ``fill_inplace`` (the root's payload and
    tail, scratch zeroed; nbytes read, nbytes + n x scratch written; the
    plain ``fill_ref`` is a ``zero_`` and two ``copy_``, the library
    yardstick too). Returns the readings by name."""
    dev = torch.device("cuda")
    lay, nb = plc.lay, plc.nbytes
    g = torch.Generator(device=dev).manual_seed(31)
    alloc = torch.randint(0, 256, (plc.alloc_bytes,), dtype=torch.uint8,
                          device=dev, generator=g)
    xb = torch.randint(0, 256, (nb,), dtype=torch.uint8, device=dev,
                       generator=g)
    res = {}
    fills = (("fill", runner.fill_inplace, runner.fill_ref,
              2 * nb + lay.n * plc.scratch * lay.row_bytes),
             ("tail", runner.unpack_tail, runner.tail_ref,
              2 * lay.n * plc.tail))
    for what, kernel, plain, moved in fills:
        args = (xb, plc, root) if what == "fill" else (plc,)
        want = alloc.clone()
        plain(want, *args)
        kernel(alloc, *args)
        torch.cuda.synchronize()
        bad = int((alloc != want).sum())
        if bad:
            fail(f"[unpack] main path {what}: {bad} bytes differ from its "
                 f"plain version")
        del want
        src, dst = alloc[:moved // 2], alloc[moved // 2:moved // 2 * 2]
        flat_ms = best_ms(lambda: dst.copy_(src))
        ms = best_ms(lambda: kernel(alloc, *args))
        plain_ms = best_ms(lambda: plain(alloc, *args))
        bound_ms = moved / rate * 1e3
        name = MAIN_FILL if what == "fill" else MAIN_TAIL
        res[name] = dict(n=lay.n, nbytes=nb, tail=plc.tail,
                         scratch_rows=plc.scratch, row_bytes=lay.row_bytes,
                         bytes=moved, bad_bytes=bad, ms=ms,
                         plain_ms=plain_ms, library_ms=plain_ms,
                         flat_copy_ms=flat_ms, bound_ms=bound_ms,
                         share_of_bound=bound_ms / ms)
        log(f"[unpack] {name}: {lay.n} devices, {nb} B a device, a tail of "
            f"{plc.tail} B, {plc.scratch} scratch rows of {lay.row_bytes} "
            f"B: byte-equal to its plain version in one launch; "
            f"{kernel.__name__} {ms!r} ms, {bound_ms / ms!r} of its "
            f"{bound_ms!r} ms bound ({moved} B at {rate / 1e12:.2f} TB/s); "
            f"{plain.__name__} {plain_ms!r} ms; a flat copy_ moving as many "
            f"bytes {flat_ms!r} ms")
    del alloc, xb, src, dst
    torch.cuda.empty_cache()
    return res


def phase_unpack(torch, runner, main_lay, rate):
    """UR's staged copy out (``unpack_rows``) against ``unpack_ref``
    on the card, byte for byte, on random buffers (padding bytes random
    too): at the main path's layout staged and at ``UNPACK_SHAPES``, one
    launch each. Each shape is timed (CUDA events, min of 3) beside
    ``unpack_ref``, the strided ``copy_`` into a held output (the library
    yardstick: ``unpack_ref``'s copies without its allocation), a flat
    ``copy_`` of as many bytes (the ceiling) and the bound, 2 x n x nbytes
    bytes at the card's memory rate. Returns the readings by shape."""
    dev = torch.device("cuda")
    shapes = {"mesh2d 16x16 main path staged": (main_lay, MAIN_NBYTES)}
    for name, (total, used, row_bytes, nbytes) in UNPACK_SHAPES:
        shapes[name] = (runner.PacketLayout(
            n=256, total=total, relay=0, plen=used // 4, used=used,
            row_bytes=row_bytes), nbytes)
    res = {}
    for name, (lay, nbytes) in shapes.items():
        g = torch.Generator(device=dev).manual_seed(27)
        buf = torch.randint(0, 256, (lay.n, lay.rows, lay.row_bytes),
                            dtype=torch.uint8, device=dev, generator=g)
        before = runner.unpack_launches
        out = runner.unpack_rows(buf, lay, nbytes)
        if runner.unpack_launches != before + 1:
            fail(f"[unpack] {name}: {runner.unpack_launches - before} "
                 f"launches, expected 1")
        # held 16 devices at a time, so that the plain version's output
        # fits beside a 128e6 B shape's 33 GB buffer and output
        bad = 0
        for a in range(0, lay.n, 16):
            part = dataclasses.replace(lay, n=min(16, lay.n - a))
            want = runner.unpack_ref(buf[a:a + part.n], part, nbytes)
            if not torch.equal(out[a:a + part.n], want):
                bad += int((out[a:a + part.n] != want).sum())
            del want
        if bad:
            fail(f"[unpack] {name}: {bad} bytes differ from unpack_ref")
        full, rem = divmod(nbytes, lay.used)

        def strided():
            out[:, :full * lay.used].view(lay.n, full, lay.used).copy_(
                buf[:, :full, :lay.used])
            if rem:
                out[:, full * lay.used:] = buf[:, full, :rem]

        src, dst = buf.view(-1)[:lay.n * nbytes], out.view(-1)
        library_ms = min(cuda_ms(strided) for _ in range(3))
        flat_ms = min(cuda_ms(lambda: dst.copy_(src)) for _ in range(3))
        del out, dst
        ms = min(cuda_ms(lambda: runner.unpack_rows(buf, lay, nbytes))
                 for _ in range(3))
        plain_ms = min(cuda_ms(lambda: runner.unpack_ref(buf, lay, nbytes))
                       for _ in range(3))
        moved = 2 * lay.n * nbytes
        bound_ms = moved / rate * 1e3
        res[name] = dict(n=lay.n, total=lay.total, used=lay.used,
                         row_bytes=lay.row_bytes, nbytes=nbytes, bytes=moved,
                         bad_bytes=bad, ms=ms, plain_ms=plain_ms,
                         library_ms=library_ms, flat_copy_ms=flat_ms,
                         bound_ms=bound_ms, share_of_bound=bound_ms / ms)
        log(f"[unpack] {name}: {lay.n} devices x {lay.total} rows of "
            f"{lay.used} B (used % 16 = {lay.used % 16}) padded to "
            f"{lay.row_bytes} B, {nbytes} B a device: byte-equal to "
            f"unpack_ref in one launch; unpack_rows {ms!r} ms = "
            f"{moved / ms / 1e9!r} TB/s, {bound_ms / ms!r} of its "
            f"{bound_ms!r} ms bound ({moved} B at {rate / 1e12:.2f} TB/s); "
            f"unpack_ref {plain_ms!r} ms; strided copy_ {library_ms!r} ms; "
            f"flat copy_ of as many bytes {flat_ms!r} ms")
        del buf, src
        torch.cuda.empty_cache()
    return res


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
EC_REF_S = 45.0           # event_core_ref's longest predicted run on a shape:
# room for the sweep row (23-31 s predicted on a fast or a slow host), not
# for 64 x 64 srda (110-145 s)
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
    outside the main path's count, on those shapes and on mesh2d 16 x 16
    srda in 12 lanes: the kernel's ``(comp, seqs)`` in its memory variant,
    and in the global one too where the shared one fits, bit for bit to
    ``event_core_ref`` on the card wherever that is predicted to take under
    ``EC_REF_S`` (its time a step on the 16 x 16 lanes, which it always
    runs, times the shape's 2n steps), elsewhere the global variant to the
    shared one (the numpy engine held the results above); each timed (CUDA
    events), a step's time and where it goes (``kernelsim.profile``), the
    compaction's time, the numpy engine's time on the same lists (host
    clock) and the bytes bound, which is not what limits a chain of 2n
    dependent steps; and the step floor of this design, the kernel on a
    chain of tasks."""
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

    KS.launches = 0
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
    launches = KS.launches

    # the kernel against the plain version on the card: the 16 x 16 lanes
    # first, whose time a step predicts the plain version's on the others
    topo, cm = model("mesh2d", (16, 16))
    c16, d16, _ = KS.lower_baseline_lanes(topo, cm, "srda", 0, sizes)
    shapes = {"plain": (topo, cm, c16, d16, [
        lower_baseline(topo, cm, "srda", 0, s) for s in sizes]), **shapes}
    out, ref_s_per_step = {}, None
    for key, (topo, cm, c, d, ctls) in shapes.items():
        c.bind(cm.compiled())
        stat = [torch.from_numpy(a).cuda() for a in
                KS._static_arrays(c, cm.compiled())]
        dt = torch.from_numpy(np.ascontiguousarray(d)).cuda()
        want, plain_ms = None, None
        if key == "plain" or ref_s_per_step * 2 * c.n < EC_REF_S:
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            want = KS.event_core_ref(*stat, dt)
            torch.cuda.synchronize()
            plain_ms = (time.perf_counter() - t1) * 1e3
            ref_s_per_step = ref_s_per_step or plain_ms / 2e3 / c.n
        row = eventcore_times(torch, KS, stat, dt, rate, key, want)
        row["plain_ms"] = plain_ms
        if key in numpy_ms:
            row["numpy_ms"] = numpy_ms[key]
        else:
            nsim = CompiledSim(topo, cm, 0)
            t1 = time.perf_counter()
            for one in ctls:
                nsim.run_lowered(one)
            row["numpy_ms"] = (time.perf_counter() - t1) * 1e3
        out[key] = row
        log(f"[eventcore] {key}: {c.n} tasks x {d.shape[0]} lanes (K "
            f"{row['K']}, D {row['D']}, {row['W']} resources, {row['kept']} "
            f"kept; {row['entries']} row entries kept of "
            f"{row['padded_entries']}; {row['memory']} memory, "
            f"{row['smem']} B dynamic shared memory): " + (
                f"bit-equal to {row['held_to']} in the variants "
                f"{row['held']}" if row['held_to'] == "event_core_ref" else
                f"held to the numpy engine earlier in the phase" + (
                    f", the variants {row['held']} bit-equal to the "
                    f"{row['memory']} one" if row['held'] else
                    ", one variant, nothing to compare on the card")) +
            f" (plain {plain_ms!r} ms once); "
            f"kernel {row['ms']!r} ms "
            f"({row['us_per_step']!r} us a step of {row['steps']}; by memory "
            f"variant {row['variants_ms']}); compaction {row['prep_ms']!r} "
            f"ms; numpy engine {row['numpy_ms']!r} ms on the same lists; "
            f"bytes bound {row['bound_ms']!r} ms (not what limits 2n "
            f"dependent steps)")

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
    out["launches"] = launches
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


def eventcore_times(torch, KS, stat, dt, rate, key, want=None):
    """The event core on one shape: the kernel's ``(comp, seqs)`` in its
    memory variant, and in the global one too where the shared one fits,
    bit for bit to ``want`` (``event_core_ref``'s) where given, else the
    global variant to the shared one where both run (``held`` lists the
    variants compared; with one variant and no ``want`` the numpy engine
    held the shape earlier in the phase); each variant timed (CUDA events, the
    least of two after a warm-up); the compaction's time; the bytes
    bound."""
    L, n = dt.shape
    st = KS.compact_structure(*stat)
    torch.cuda.synchronize()
    prep_ms = min(cuda_ms(lambda: KS.compact_structure(*stat))
                  for _ in range(3))
    memory = KS.variant(n, st.caps.numel())
    variants = (memory, "global") if memory == "shared" else (memory,)
    held_to = "event_core_ref" if want is not None else "numpy engine"
    against = held_to if want is not None else f"the {memory} variant"
    base = None                      # the variant ``want`` came from
    if want is None and len(variants) > 1:
        want, base = KS.launch(st, dt, memory=memory), memory
    mismatches, max_abs_err = 0, 0.0
    variants_ms, held = {}, []
    for mem in variants:
        if want is not None and mem != base:
            got = KS.launch(st, dt, memory=mem)
            mismatches += int((got[0] != want[0]).sum()) + \
                int((got[1] != want[1]).sum())
            max_abs_err = max(max_abs_err, float(
                (got[0] - want[0]).abs().nan_to_num(0.0).max()))
            if not (torch.equal(got[0], want[0]) and
                    torch.equal(got[1], want[1])):
                fail(f"[eventcore] {key}: the {mem} variant differs from "
                     f"{against} in {mismatches} elements (largest "
                     f"difference {max_abs_err!r})")
            held.append(mem)
        variants_ms[mem] = min(cuda_ms(lambda: KS.launch(st, dt, memory=mem))
                               for _ in range(2))
    lib = KS._kernel()
    ms = variants_ms[memory]
    prof = eventcore_profile(KS, st, dt, key)
    return dict(tasks=n, lanes=L, steps=2 * n, K=stat[1].shape[1],
                D=stat[3].shape[1], W=stat[2].shape[0],
                kept=st.caps.numel(), entries=st.row_res.numel(),
                padded_entries=stat[1].numel(), memory=memory,
                smem=lib.event_core_shared_bytes(
                    n, st.caps.numel(), int(memory == "shared")),
                ms=ms, us_per_step=ms * 1e3 / (2 * n), held_to=held_to,
                mismatches=mismatches, max_abs_err=max_abs_err,
                held=held, variants_ms=variants_ms, prep_ms=prep_ms,
                profile=prof, bound_ms=event_core_bytes(st, L) / rate * 1e3)


def distributed_rank(rank, world, backend, device, store, out):
    """One rank of ``phase_distributed``: ring ``world`` BBS broadcasts from
    roots 0 and world - 1 across the group, each rank's copy against the
    virtual mesh's on this rank's device and against the payload, each
    timed by ``ex.measure(x, reps=3, group=WORLD)``; writes
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
            secs = ex.measure(x, reps=3, group=dist.group.WORLD)
            res[str(root)] = dict(
                equal=bool(torch.equal(mine.view(torch.uint8),
                                       virtual.view(torch.uint8))),
                ok=chk.ok, missing=list(chk.missing), device=str(mine.device),
                subrounds=ex.num_subrounds, ms=secs * 1e3)
        res["calibration"] = calibrate_rank(
            rank, world, cfg, os.path.dirname(out))
    finally:
        dist.destroy_process_group()
    with open(f"{out}.{rank}.json", "w") as f:
        json.dump(res, f)


def calibrate_rank(rank, world, cfg, tmp):
    """The calibration across the group, on one rank of
    ``distributed_rank``: ``calibrate(ring(world), group=WORLD)`` at the
    ring ladder (its K1 launches counted), the artifact stored under the
    group's ``CalibrationKey`` and reloaded, and ``prediction_report`` of
    BBS, ``binomial`` and ``pipeline`` at 4 and 16 MiB on ``ring(world)``
    and, at 4 or 8 ranks, ``mesh2d(2, world / 2)``, each verified across
    the group first, its ``permute_step`` launches counted, and this rank's
    writes a run (``distributed.bbs_tables``' ``r_ok``). Returns what this
    rank saw."""
    import importlib
    import torch.distributed as dist
    from repro_torch import api
    from repro_torch.core import topology as T
    from repro_torch.core.planstore import CalibrationKey, PlanStore
    from repro_torch.device import distributed as D
    from repro_torch.device import round_step as rs
    C = importlib.import_module("repro_torch.device.calibrate")

    group = dist.group.WORLD
    topo = T.ring(world)
    t0 = time.perf_counter()
    before = rs.launches
    cost = C.calibrate(topo, group=group, device=cfg.device.device,
                       sizes=CAL_RING_SIZES, iters=CAL_ITERS, reps=CAL_REPS)
    launches = rs.launches - before
    cal_s = time.perf_counter() - t0
    key = CalibrationKey.for_topology(topo, cost.meta["backend"], world)
    virtual = CalibrationKey.for_topology(topo, "cuda", world)
    plans = os.path.join(tmp, f"plans{rank}")
    path = PlanStore(plans).store_calibration(key, cost)
    back, _ = PlanStore(plans).load_calibration(key)
    topos = [topo] + ([T.mesh2d(2, world // 2)] if world in (4, 8) else [])
    rows = []
    for fabric in topos:
        model = api.compile(fabric)
        for nbytes in (CAL_RING_NBYTES, DIST_NBYTES):
            for algo in ("bbs", "binomial", "pipeline"):
                ex = model.executable(root=0, nbytes=nbytes, algo=algo,
                                      config=cfg)
                chk = ex.verify(ex.default_payload(), group=group)
                before = rs.launches
                row, = C.prediction_report([ex], cost, reps=CAL_REPS,
                                           group=group)
                tabs, _ = D.bbs_tables(ex.schedule, ex.num_groups, rank)
                rows.append(dict(
                    launches=rs.launches - before,
                    writes=int(tabs[:, 4].sum()),
                    topo=fabric.name, algo=algo, candidate=ex.candidate,
                    nbytes=nbytes, groups=ex.num_groups,
                    cycles=row.num_cycles, subrounds=ex.num_subrounds,
                    ok=chk.ok, missing=list(chk.missing),
                    predicted_cycle_s=row.predicted_cycle_s,
                    measured_cycle_s=row.measured_cycle_s,
                    rel_err=row.rel_err))
    return dict(cost=cost.to_dict(), launches=launches, seconds=cal_s,
                reloaded_equal=back == cost, artifact=os.path.basename(path),
                key=key.digest(), virtual_key=virtual.digest(),
                report=rows, report_s=time.perf_counter() - t0 - cal_s)


def phase_distributed(torch, world=None, backend="nccl", device="cuda"):
    """The distributed executor (``repro_torch.device.distributed``) over
    ``min(8, device_count)`` NCCL ranks, one GPU each, when the machine has
    two or more GPUs: ring BBS broadcasts of 16 MiB, each rank's copy bit
    for bit against the virtual mesh's; then the calibration across the
    ranks (``calibrate_rank``, ``group_calibration``): alpha and beta of
    the links between the GPUs and the prediction report of BBS and two
    baselines. On one GPU it is not run (NCCL puts no two ranks on one GPU)
    and says so. ``world``, ``backend`` and ``device`` let a CPU rehearsal
    run it on gloo."""
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
    cal_ranks = [rk.pop("calibration") for rk in ranks]
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
            f"{ms!r} ms a broadcast, ex.measure(group=): host clock, "
            f"slowest rank, least of 3 windows after a warm-up, set-up "
            f"outside them; "
            f"devices {res[root]['devices']})")
    cal = group_calibration(cal_ranks, world, backend, device)
    log(f"[distributed] phase time {time.perf_counter() - t0:.3f} s")
    return dict(world=world, backend=backend, roots=res, calibration=cal)


def group_calibration(ranks, world, backend, device):
    """Gate and print what ``calibrate_rank`` saw on every rank: one cost on
    every rank, delivered (``calibrate`` raises otherwise), finite alpha >= 0
    and beta > 0, the meta of the group (``emulated`` False on NCCL), one K1
    launch a ring sub-round on a GPU, the artifact reloaded equal under a
    key that is not the virtual mesh's; each report row verified on every
    rank, with one finite positive measured and predicted time, and on a
    GPU one ``permute_step`` launch for each of the rank's writes in each of
    the ``CAL_REPS + 1`` measured runs. The times, ``rel_err`` and whether
    beta hit the fit's clamp (``meta["beta_clamped"]``) are readings."""
    from repro_torch.device.calibrate import CalibratedCost
    cost = CalibratedCost.from_dict(ranks[0]["cost"])
    if any(CalibratedCost.from_dict(rk["cost"]) != cost for rk in ranks):
        fail("[distributed] the ranks' calibrations differ")
    (cls, (alpha, beta)), = cost.classes.items()
    meta = cost.meta
    if not (math.isfinite(alpha) and math.isfinite(beta) and alpha >= 0
            and beta > 0):
        fail(f"[distributed] calibration alpha {alpha}, beta {beta}")
    want = (f"{device.split(':')[0]}-{backend}", backend != "nccl", "group",
            world, list(range(world)))
    if (meta["backend"], meta["emulated"], meta["axis"], meta["num_devices"],
            meta["ranks"]) != want or not isinstance(
                meta.get("beta_clamped"), bool):
        fail(f"[distributed] calibration meta {meta}, expected {want}")
    sub = len(CAL_RING_SIZES) * (CAL_REPS + 1) * CAL_ITERS
    want_launches = sub if device.startswith("cuda") else 0
    if any(rk["launches"] != want_launches for rk in ranks):
        fail(f"[distributed] permute_step launches in the calibration "
             f"{[rk['launches'] for rk in ranks]}, expected {want_launches} "
             f"a rank ({sub} ring sub-rounds)")
    if not all(rk["reloaded_equal"] for rk in ranks) or \
            any(rk["key"] == rk["virtual_key"] for rk in ranks):
        fail("[distributed] the group's calibration artifact did not reload "
             "equal, or its key is the virtual mesh's")
    clamp = (" at the fit's clamp: the rounds do not grow with the row, so "
             "alpha is the whole cost of a sub-round and beta no link rate"
             if meta["beta_clamped"] else "")
    log(f"[distributed] calibrate ring {world} across {world} {backend} "
        f"ranks ({meta['device_name']}): class {cls}, alpha "
        f"{alpha * 1e6!r} us, beta {beta / 1e9!r} GB/s{clamp}, fit "
        f"residual {meta['fit_residual_seconds'] * 1e6!r} us; the same on "
        f"every rank, ring delivered at every size, {want_launches} "
        f"permute_step launches a rank; backend {meta['backend']}, emulated "
        f"{meta['emulated']}; stored as {ranks[0]['artifact']} and reloaded "
        f"equal (key {ranks[0]['key']}, virtual mesh {ranks[0]['virtual_key']}"
        f"); {max(rk['seconds'] for rk in ranks):.3f} s")
    for size, rb, t in zip(meta["sizes"], meta["row_bytes"],
                           meta["round_seconds"]):
        log(f"[distributed]   {size} B a link (row {rb} B): {t * 1e6!r} us "
            f"a round, slowest rank, least of {CAL_REPS} windows of "
            f"{CAL_ITERS}")
    report = []
    for i, row in enumerate(ranks[0]["report"]):
        mine = [rk["report"][i] for rk in ranks]
        bad = [r for r, m in enumerate(mine) if not m["ok"] or m["missing"]]
        if bad:
            fail(f"[distributed] {row['topo']} {row['algo']} {row['nbytes']} "
                 f"B: ranks {bad} did not get the payload")
        if any(m["measured_cycle_s"] != row["measured_cycle_s"]
               for m in mine):
            fail(f"[distributed] {row['topo']} {row['algo']}: the ranks "
                 f"measured different times")
        runs = (CAL_REPS + 1) if device.startswith("cuda") else 0
        if any(m["launches"] != m["writes"] * runs for m in mine):
            fail(f"[distributed] {row['topo']} {row['algo']} "
                 f"{row['nbytes']} B: permute_step launches "
                 f"{[m['launches'] for m in mine]}, expected "
                 f"{[m['writes'] * runs for m in mine]}")
        for k in ("predicted_cycle_s", "measured_cycle_s"):
            if not 0 < row[k] < float("inf"):
                fail(f"[distributed] {row['topo']} {row['algo']} "
                     f"{row['nbytes']} B: {k} {row[k]}")
        log(f"[distributed]   report {row['topo']} {row['algo']} "
            f"({row['candidate']}, m={row['groups']}, {row['cycles']} cycles, "
            f"{row['subrounds']} sub-rounds) {row['nbytes']} B: verified on "
            f"every rank; permute_step launches a rank "
            f"{[m['launches'] for m in mine]} (its writes x {runs}); cycle "
            f"predicted {row['predicted_cycle_s'] * 1e6!r} "
            f"us, measured {row['measured_cycle_s'] * 1e6!r} us, rel_err "
            f"{row['rel_err']!r}")
        report.append(row)
    return dict(topo=f"ring_{world}", link_class=cls, alpha_s=alpha,
                beta_bytes_per_s=beta, beta_clamped=meta["beta_clamped"],
                fit_residual_s=meta["fit_residual_seconds"],
                sizes=meta["sizes"], row_bytes=meta["row_bytes"],
                round_s=meta["round_seconds"], backend=meta["backend"],
                emulated=meta["emulated"], devices=meta["device_name"],
                launches=want_launches, key=ranks[0]["key"],
                seconds=max(rk["seconds"] for rk in ranks),
                report_s=max(rk["report_s"] for rk in ranks), report=report)


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
    # zamba2-7b's prefill: 56 heads of 128, state 64 (ssd_tc<128, 64>, one
    # block an SM; float32 on ssd_fma)
    for dtype, tol in ((bf, BF16_TOL), (f32, F32_TOL)):
        args = ssd_inputs(torch, *ZAMBA_SSD, dtype, 9)
        compare(torch, K.ssd_scan(*args, chunk=chunk),
                ref.ssd_chunked(*args, chunk=chunk), tol,
                f"zamba2-7b prefill shape {ZAMBA_SSD} {dtype}")
        del args
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


def decode_vs_forward(torch, model, batch, what, **rule):
    """Teacher-forced ``decode_step`` over ``batch["tokens"]`` against
    ``forward(batch)``; an encdec's cache attends to its encoder's pass over
    ``batch["frames"]``, as the serve loop's does."""
    tokens = batch["tokens"].cuda()
    full = model.forward(batch)
    b, s = tokens.shape
    frames = batch.get("frames")
    cache = model.init_cache(b, s, enc_len=0 if frames is None else
                             frames.shape[1])
    if frames is not None:
        cache["enc"] = model._encoder(frames)
    steps = torch.empty_like(full)
    for t in range(s):
        steps[:, t] = model.decode_step(cache, tokens[:, t:t + 1])[0][:, 0]
    return logits_err(torch, steps, full, what, **rule), full


def phase_decode(torch, model, f32, cfg, SyntheticTokens):
    """Teacher-forced decode against forward over 4 x 256 tokens, at full
    depth: in float32 within F32_MODEL_TOL, in bf16 within twice bf16's own
    distance from float32 (as in the prefill)."""
    toks = SyntheticTokens(cfg, seq_len=256, global_batch=4).batch(1)
    toks = toks["tokens"].cuda()
    err32, full32 = decode_vs_forward(
        torch, f32, dict(tokens=toks), f"decode_step vs forward, 4x256, "
        f"float32, {cfg.layers} layers", tol=F32_MODEL_TOL)
    full16 = model.forward(dict(tokens=toks))
    noise = logits_err(torch, full16, full32, "forward 4x256 bf16 vs "
                       "float32 (bf16's own error)")
    del full16, full32
    err, _ = decode_vs_forward(torch, model, dict(tokens=toks),
                               f"decode_step vs forward, "
                               f"4x256, bf16, {cfg.layers} layers",
                               bound=2 * noise)
    return err, err32, noise


def phase_serve(torch, serve, cfg, tokens=32, prompt=32):
    gen = serve.main(["--arch", cfg.name, "--batch", "4",
                      "--prompt-len", str(prompt), "--tokens", str(tokens)])
    if tuple(gen.shape) != (4, tokens) or gen.dtype != torch.int32 or \
            int(gen.min()) < 0 or int(gen.max()) >= cfg.padded_vocab:
        fail(f"serve returned {gen.dtype} {tuple(gen.shape)} tokens")
    log(f"[serve] serve.main --arch {cfg.name}: (4, {tokens}) greedy tokens; "
        f"first row "
        f"{gen[0, :8].tolist()}")


def phase_ssd_timing(torch, K, ref, rate):
    """K3 at the prefill shape in bf16 (the tensor-core kernel): ``ms`` the
    minimum of 2 eager loops of 20 launches over 20 (the wrapper's host work
    included); ``graph_ms`` the same 20 launches in a CUDA graph; ``host_ms``
    the wrapper's host time per call (20 calls issued back to back); its
    bound (the function's bytes and FLOP, full C B^T and W x tiles, not the
    split's extra products), TFLOP/s and share of the bound on those FLOP;
    the plain version; then zamba2-7b's shape in bf16 (an eager loop of 20)
    against its bound, and the float32 FMA kernel once at the prefill
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
    # zamba2-7b's shape: 56 heads of 128, state 64 (one block an SM)
    zb, zs, zh, zdh, zds = ZAMBA_SSD
    args = ssd_inputs(torch, *ZAMBA_SSD, torch.bfloat16, 10)
    z_bytes = sum(t.numel() * t.element_size() for t in args) + \
        args[0].numel() * args[0].element_size()
    z_flops = zb * zh * -(-zs // chunk) * (2 * chunk * chunk * (zds + zdh) +
                                           4 * chunk * zds * zdh)
    z_bound = max(z_bytes / rate, z_flops / BF16_PEAK) * 1e3
    z_ms = min(cuda_ms(lambda: [K.ssd_scan(*args, chunk=chunk)
                                for _ in range(reps)])
               for _ in range(2)) / reps
    log(f"[timing] ssd_scan at zamba2-7b's {ZAMBA_SSD}, bf16: {z_ms!r} ms "
        f"per launch (eager loop of {reps}), bound {z_bound!r} ms "
        f"({z_bytes} B, {z_flops} FLOP), {z_bound / z_ms!r} of it")
    del args
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
                f32_ms=f32_ms, zamba2=dict(ms=z_ms, bound_ms=z_bound))


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
    res = serve.generate(model, toks, 32)
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
    cases += [(f"{what} {shape} {'causal' if causal else 'non-causal'} "
               f"{name}", shape, dtype, causal)
              for what, shape, causal in NEW_ATTN
              for name, dtype in (("bf16", bf), ("float32", f32))]
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
    new = {}
    for i, (what, shape, causal) in enumerate(NEW_ATTN):
        args = attn_inputs(torch, *shape, torch.bfloat16, 43 + i)
        nb, nhq, nhkv, ns, nt, nd = shape
        n_flops = 4 * nd * nb * nhq * attn_pairs(ns, nt, causal)
        n_bytes = sum(x.numel() * x.element_size() for x in args) + \
            args[0].numel() * args[0].element_size()
        n_bound = max(n_bytes / rate, n_flops / BF16_PEAK) * 1e3
        n_by = "bytes" if n_bytes / rate >= n_flops / BF16_PEAK else \
            "operations"
        n_ms = eager_ms(lambda: FA.flash_attention(*args, causal=causal))
        n_sdpa = eager_ms(lambda: sdpa(*args, is_causal=causal,
                                       enable_gqa=nhq != nhkv))
        log(f"[timing] flash_attention at {what} {shape}, bf16, "
            f"{'causal' if causal else 'non-causal'}: {n_ms!r} ms per launch "
            f"(eager loop of {reps}), {n_flops / n_ms / 1e9!r} TFLOP/s, "
            f"bound {n_bound!r} ms ({n_by}: {n_flops} FLOP, {n_bytes} B), "
            f"{n_bound / n_ms!r} of it; scaled_dot_product_attention "
            f"{n_sdpa!r} ms (yardstick), {n_ms / n_sdpa!r} times its time")
        new[what] = dict(shape=list(shape), causal=causal, ms=n_ms,
                         library_ms=n_sdpa, bound_ms=n_bound, bound_by=n_by)
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
                f32_ms=f32_ms, d112_ms=z_ms, new_shapes=new)


# the families' full-width serving phases: arch, K2 and K3 launches a
# 4 x 2048 prefill (from the configs and padded_heads), and the depth of the
# float32 twin (None: the full depth). zamba2-7b's twin keeps 12 of its 81
# Mamba-2 blocks (two shared-attention periods): 8.7 B float32 parameters
# would not fit beside the bf16 model.
FAMILIES = (("llava-next-mistral-7b", 32, 0, None),
            ("granite-moe-1b-a400m", 24, 0, None),
            ("zamba2-7b", 13, 81, 12),
            ("seamless-m4t-large-v2", 72, 0, None))
FAMILY_BATCH, FAMILY_SEQ = 4, 2048
FAMILY_DECODE = 64          # teacher-forced decode against forward, 4 x 64
FAMILY_SERVE = 16           # serve.main --tokens
FAMILY_PROMPT = 8           # serve.main --prompt-len
_STACKED = ("mamba.", "attn.", "mlp.", "moe.", "cross.")


def twin(LM, model, cfg, layers=None, **kw):
    """``LM(cfg.scaled(**kw))`` with ``model``'s weights (widened or narrowed
    to its dtype); with ``layers``, the first ``layers`` decoder (or Mamba-2)
    blocks only: a cut in depth."""
    cfg = cfg.scaled(**kw) if layers is None else \
        cfg.scaled(layers=layers, **kw)
    out = LM(cfg)
    state = {k: (v[:layers] if layers is not None and
                 k.startswith(_STACKED) else v)
             for k, v in model.state_dict().items()}
    out.load_state_dict(state)
    return out


def family_batch(SyntheticTokens, cfg, seq, step, patches=True):
    """``SyntheticTokens`` step ``step`` on the card; a vlm's patches only
    with ``patches`` (decode has no patch path)."""
    batch = SyntheticTokens(cfg, seq_len=seq,
                            global_batch=FAMILY_BATCH).batch(step)
    if not patches:
        batch.pop("patches", None)
    return {k: v.cuda() for k, v in batch.items()}


def positions_of(cfg, batch):
    """Cache positions a prefill of ``batch`` takes: a vlm's patches
    count."""
    n = batch["tokens"].shape[1]
    return n + (batch["patches"].shape[1] if "patches" in batch else 0)


def fresh_cache(model, batch, extra=0):
    frames = batch.get("frames")
    return model.init_cache(FAMILY_BATCH, positions_of(model.cfg, batch) +
                            extra, enc_len=0 if frames is None else
                            frames.shape[1])


def kernels_vs_plain(torch, FA, K, ref, ops, model, batch, what):
    """``model.forward(batch)`` with K2 and K3 each held against its plain
    version on the inputs of the first and of the last launch of each kind
    (K2: causal or not, and its S and T; K3: one kind). Returns the max
    abs error by kind and the number of launches checked."""
    errs, last, seen = {}, {}, {}

    def check(kind, out, plain, args):
        errs[kind] = max(errs.get(kind, 0.0), compare(
            torch, out, plain(*args), BF16_TOL, f"{what} {kind}",
            quiet=True, tag="lm"))

    def attention(q, k, v, causal=True):
        o = real_attn(q, k, v, causal=causal)
        kind = (f"flash_attention {'causal' if causal else 'non-causal'} "
                f"S={q.shape[2]} T={k.shape[2]}")
        def plain(*a):
            return ref.attention_ref(*a, causal=causal)
        if kind not in seen:
            check(kind, o, plain, (q, k, v))
        seen[kind] = seen.get(kind, 0) + 1
        last[kind] = (o, plain, (q, k, v))
        return o

    def ssd(x, dt, A, B, C):
        y = real_ssd(x, dt, A, B, C)
        kind = "ssd_scan"
        if kind not in seen:
            check(kind, y, ref.ssd_chunked, (x, dt, A, B, C))
        seen[kind] = seen.get(kind, 0) + 1
        last[kind] = (y, ref.ssd_chunked, (x, dt, A, B, C))
        return y

    real_attn, real_ssd = ops.attention, ops.ssd
    ops.attention, ops.ssd = attention, ssd
    try:
        model.forward(batch)
    finally:
        ops.attention, ops.ssd = real_attn, real_ssd
    for kind, (out, plain, args) in last.items():
        if seen[kind] > 1:
            check(kind, out, plain, args)
    for kind in sorted(seen):
        log(f"[{what}] {kind}: {seen[kind]} launches in forward; the first "
            f"and the last held against the plain version: max_abs_err "
            f"{errs[kind]!r} (tolerance {BF16_TOL} abs + {BF16_TOL} rel)")
    return errs


def phase_family(torch, FA, K, KS, rs, ref, ops, serve, cfg, LM,
                 SyntheticTokens, k2, k3, twin_layers, name):
    """One family's serving path at full width (random weights from seed
    0): ``LM.prefill`` of 4 x 2048 ``SyntheticTokens`` (a vlm's 256 patches
    before them, an encdec's 2048 frames beside them) with exactly ``k2``
    K2 and ``k3`` K3 launches and none of K1 or EC, finite logits, the
    cache filled; K2 and K3 against their plain versions on the first and
    last launch of each kind; the bf16 prefill within twice bf16's own
    distance from a float32 twin (cut in depth to ``twin_layers``), and
    the twin's K2/K3 prefill against its plain one; teacher-forced
    ``decode_step`` against ``forward`` over 4 x 64 tokens in both dtypes
    (a moe on twins whose capacity factor E / k drops no token: capacity
    depends on the sequence length, so S = 1 and S = 2048 route apart at
    the default factor); for vlm, moe and encdec a decode step after a
    ``prefill``-filled cache against ``forward`` on one more token; and
    ``serve.main --arch <id> --prompt-len 8 --tokens 16``; prefill and
    decode time, peak memory and a profile of each. Returns the
    readings."""
    t0 = time.perf_counter()
    tag = cfg.name
    b, s = FAMILY_BATCH, FAMILY_SEQ
    model = LM(cfg)
    params = sum(p.numel() for p in model.parameters())
    batch = family_batch(SyntheticTokens, cfg, s, 0)
    n = positions_of(cfg, batch)
    cache = fresh_cache(model, batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    FA.launches = K.launches = rs.launches = rs.rounds_launches = 0
    KS.launches = 0
    logits, cache = model.prefill(batch, cache)
    torch.cuda.synchronize()
    got = (FA.launches, K.launches, rs.launches, rs.rounds_launches,
           KS.launches)
    peak = torch.cuda.max_memory_allocated()
    if got != (k2, k3, 0, 0, 0):
        fail(f"{tag} prefill launched flash_attention, ssd_scan, "
             f"permute_step, permute_rounds and event_core {got} times, "
             f"expected {(k2, k3, 0, 0, 0)}")
    want_shape = (b, n, cfg.padded_vocab)
    if tuple(logits.shape) != want_shape:
        fail(f"{tag} prefill logits {tuple(logits.shape)}, expected "
             f"{want_shape}")
    if not all(bool(torch.isfinite(logits[i]).all()) for i in range(b)):
        fail(f"{tag} prefill logits are not finite")
    if "k" in cache and cfg.family != "hybrid" and (
            int(cache["pos"]) != n or not bool(cache["k"][:, :, :, n - 1]
                                               .any())):
        fail(f"{tag}: the prefill did not fill the k/v cache")
    if cfg.family == "encdec" and not bool(cache["enc"].any()):
        fail(f"{tag}: the prefill did not write the encoder's states")
    ms = min(cuda_ms(lambda: model.prefill(batch, cache)) for _ in range(2))
    log(f"[{tag}] {params} parameters; prefill {b}x{s}"
        f"{f' + {n - s} patches' if n > s else ''}"
        f"{f' and {b}x{s} frames' if 'frames' in batch else ''}: "
        f"{k2} flash_attention and {k3} ssd_scan launches (none of K1 or "
        f"EC), finite logits {want_shape}; {ms!r} ms (CUDA events, min of "
        f"2), peak memory {peak} B ({name})")
    del cache
    errs = kernels_vs_plain(torch, FA, K, ref, ops, model, batch, tag)

    # the float32 twin, and the bf16 model at the twin's depth
    cut = twin_layers is not None
    m16 = twin(LM, model, cfg, twin_layers) if cut else model
    f32 = twin(LM, model, cfg, twin_layers, dtype="float32")
    depth = f"{m16.cfg.layers} of {cfg.layers} layers" if cut else \
        f"{cfg.layers} layers"
    log(f"[{tag}] float32 twin: {depth}" + (
        " (cut in depth only: the bf16 model is cut alike for the "
        "comparisons against it)" if cut else ""))
    if cut:
        logits = m16.forward(batch)
    with attention_as(ops, ref.attention_ref), ssd_as(ops, ref.ssd_chunked):
        plain32 = f32.forward(batch)
        plain16 = m16.forward(batch)
    got32 = f32.forward(batch)
    err32 = logits_err(torch, got32, plain32, f"{tag} prefill float32 "
                       f"({depth}): kernels vs plain", tol=F32_MODEL_TOL)
    del got32
    noise = logits_err(torch, plain16, plain32, f"{tag} prefill ({depth}): "
                       f"plain bf16 vs float32 (bf16's own error)")
    err = logits_err(torch, logits, plain16, f"{tag} prefill bf16 "
                     f"({depth}): kernels vs plain", bound=2 * noise)
    del logits, plain16, plain32
    torch.cuda.empty_cache()

    # decode against forward (a moe's on twins that drop no token)
    if cfg.family == "moe":
        nd = dict(capacity_factor=cfg.num_experts / cfg.top_k)
        m16 = twin(LM, model, cfg, **nd)
        f32 = twin(LM, f32, cfg, dtype="float32", **nd)
        cap = max(1, int(cfg.capacity_factor * s * cfg.top_k /
                         cfg.num_experts))
        log(f"[{tag}] decode checks on twins with capacity factor "
            f"{nd['capacity_factor']} (E / k: no token dropped at any "
            f"length); at the default {cfg.capacity_factor} a prefill's "
            f"capacity {cap} and decode's 1 route a dropped token apart by "
            f"design")
    dbatch = family_batch(SyntheticTokens, cfg, FAMILY_DECODE, 1,
                          patches=False)
    steps = f"{b}x{FAMILY_DECODE}"
    err_d32, full32 = decode_vs_forward(
        torch, f32, dbatch, f"{tag} decode_step vs forward, {steps}, "
        f"float32 ({depth})", tol=F32_MODEL_TOL)
    full16 = m16.forward(dbatch)
    dnoise = logits_err(torch, full16, full32, f"{tag} forward {steps} bf16 "
                        f"vs float32 (bf16's own error)")
    del full16, full32
    err_d, _ = decode_vs_forward(torch, m16, dbatch, f"{tag} decode_step vs "
                                 f"forward, {steps}, bf16 ({depth})",
                                 bound=2 * dnoise)
    if cfg.family != "hybrid":
        # prefill FAMILY_DECODE tokens (a vlm's patches before them), then
        # decode one more; forward over all of them
        pbatch = family_batch(SyntheticTokens, cfg, FAMILY_DECODE + 1, 2)
        head = dict(pbatch, tokens=pbatch["tokens"][:, :-1])
        for m, dt, rule in ((f32, "float32", dict(tol=F32_MODEL_TOL)),
                            (m16, "bf16", dict(bound=2 * dnoise))):
            c = fresh_cache(m, pbatch)
            m.prefill(head, c)
            step = m.decode_step(c, pbatch["tokens"][:, -1:])[0]
            want = m.forward(pbatch)[:, -1:]
            logits_err(torch, step, want, f"{tag} decode_step after "
                       f"prefill({positions_of(cfg, head)} positions) vs "
                       f"forward at the next, {dt}", **rule)
            del c
    del m16, f32
    torch.cuda.empty_cache()

    # a profile of the prefill, decode time after it, a profile of four
    # decode steps, then serve
    cache = fresh_cache(model, batch, extra=16)
    kinds, busy, wall = profile_window(
        torch, lambda: model.prefill(batch, cache), f"{tag} prefill {b}x{s}")
    cur = batch["tokens"][:, :1]
    model.decode_step(cache, cur)
    reps = 8
    step_ms = cuda_ms(lambda: [model.decode_step(cache, cur)
                               for _ in range(reps)]) / reps
    log(f"[{tag}] decode_step, batch {b}, after the {b}x{n} prefill: "
        f"{step_ms!r} ms per step (eager, {reps} steps; {name})")
    _, dbusy, dwall = profile_window(
        torch, lambda: [model.decode_step(cache, cur) for _ in range(2)],
        f"{tag} 2 decode steps after the prefill, batch {b}")
    del cache, model, batch
    torch.cuda.empty_cache()
    phase_serve(torch, serve, cfg, tokens=FAMILY_SERVE,
                prompt=FAMILY_PROMPT)
    torch.cuda.empty_cache()
    secs = time.perf_counter() - t0
    log(f"[{tag}] phase time {secs:.3f} s")
    return dict(params=params, k2=k2, k3=k3, prefill_ms=ms, peak=peak,
                decode_ms=step_ms, prefill_busy_share=busy / wall,
                prefill_kernel_ms={k: v / 1e3 for k, v in kinds.items()},
                decode_busy_share=dbusy / dwall, err=err, err32=err32,
                layer_errs=errs,
                decode_err=err_d, decode_err32=err_d32, twin_layers=(
                    twin_layers or cfg.layers), secs=secs)


# ---------------------------------------------------------------- [train]

TRAIN_BATCH, TRAIN_SEQ = 8, 128        # the train CLI's defaults
TRAIN_STEPS = 8                        # llama3.2-3b steps at full width
TRAIN_LR = 1e-3
CLI_STEPS, CLI_EVERY = 12, 6           # the CLI run of mamba2-370m
GRAD_ATTN = (("llama3.2-3b prefill", ATTN_MAIN, True),
             ("llama3.2-3b training", (8, 32, 16, 128, 128, 128), True),
             ("non-causal S != T", (4, 16, 16, 512, 2048, 64), False))
GRAD_SSD = (("mamba2-370m prefill", SSD_MAIN[:5], None),
            ("zamba2-7b prefill", ZAMBA_SSD, None),
            ("overflow regime (dt = 2, A = -1)", SSD_MAIN[:5], (2.0, -1.0)))


def counts(FA, K, rs, KS):
    """The launch counters of K2, K3, K1 (both kernels), EC and UR."""
    from repro_torch.device import runner
    return (FA.launches, K.launches, rs.launches, rs.rounds_launches,
            KS.launches, runner.unpack_launches)


def reset_counts(FA, K, rs, KS):
    from repro_torch.device import runner
    FA.launches = K.launches = rs.launches = rs.rounds_launches = 0
    KS.launches = runner.unpack_launches = 0


def grad_vs_plain(torch, fn, plain, inputs, what, counter):
    """``fn(*inputs)`` with every input requiring grad: one launch (the
    forward, read from ``counter()``), and input gradients for one fixed
    upstream gradient bit-equal to autograd through ``plain`` on the same
    inputs, and finite. Returns the largest gradient entry."""
    leaves = [t.detach().clone().requires_grad_() for t in inputs]
    before = counter()
    out = fn(*leaves)
    if counter() != before + 1 or out.grad_fn is None:
        fail(f"[train] {what}: the forward launched the kernel "
             f"{counter() - before} times (expected 1), grad_fn "
             f"{out.grad_fn}")
    g = torch.Generator(device="cuda").manual_seed(7)
    up = torch.randn(out.shape, device="cuda", generator=g).to(out.dtype)
    got = torch.autograd.grad(out, leaves, up)
    del out
    twins = [t.detach().clone().requires_grad_() for t in inputs]
    want = torch.autograd.grad(plain(*twins), twins, up)
    largest = 0.0
    for i, (a, b) in enumerate(zip(got, want)):
        if not bool(torch.isfinite(a.float()).all()):
            fail(f"[train] {what}: input {i}'s gradient is not finite")
        if a.dtype != b.dtype or not torch.equal(a, b):
            fail(f"[train] {what}: input {i}'s gradient differs from the "
                 f"plain version's (max "
                 f"{float((a.float() - b.float()).abs().max())!r})")
        largest = max(largest, float(a.float().abs().max()))
    log(f"[train] {what}: the kernel's forward (1 launch), gradients of "
        f"{len(got)} inputs bit-equal to autograd through the plain version "
        f"and finite (largest entry {largest!r})")
    return largest


def phase_train_grad(torch, FA, K, ref):
    """K2 and K3 through ``kernels.grad.KernelGrad`` on the card: K2 at
    llama3.2-3b's prefill and training shapes and a non-causal S != T
    shape, K3 at Mamba-2's and zamba2-7b's prefill shapes and in the
    overflow regime, all bf16."""
    for what, (b, hq, hkv, s, t, d), causal in GRAD_ATTN:
        inputs = attn_inputs(torch, b, hq, hkv, s, t, d, torch.bfloat16, 11)

        def attn(q, k, v, causal=causal):
            return FA.flash_attention(q, k, v, causal=causal)

        def plain(q, k, v, causal=causal):
            return ref.attention_ref(q, k, v, causal=causal)

        grad_vs_plain(torch, attn, plain, inputs, f"K2 {what} "
                      f"{(b, hq, hkv, s, t, d)} causal={causal}",
                      lambda: FA.launches)
        torch.cuda.empty_cache()
    for what, (b, s, h, dh, ds), regime in GRAD_SSD:
        dt_value, a = regime or (None, None)
        inputs = ssd_inputs(torch, b, s, h, dh, ds, torch.bfloat16, 12,
                            dt_value=dt_value, a=a)
        grad_vs_plain(torch, K.ssd_scan, ref.ssd_chunked, inputs,
                      f"K3 {what} {(b, s, h, dh, ds)}", lambda: K.launches)
        torch.cuda.empty_cache()


def grads_of(torch, value_and_grad, model, batch):
    """(loss, {name: gradient}) of ``model.loss(batch)``."""
    model.requires_grad_(True)
    loss, grads = value_and_grad(model, dict(model.named_parameters()),
                                 batch)
    return float(loss), grads


def leaf_dist(torch, a, b):
    return float((a.float() - b.float()).abs().max())


def phase_train_loss(torch, FA, K, rs, KS, ref, ops, cfg, LM,
                     SyntheticTokens, value_and_grad, launches):
    """One ``LM.loss`` and backward at full width and depth, 8 x 128,
    through the kernels (exactly ``launches`` K2 or K3 launches) and
    through the plain versions, in bf16 and on the float32 twin. Gates:
    the twin's kernel path within 1e-3 of its plain path (loss, and each
    gradient against its largest entry); each bf16 kernel-path gradient
    within twice the plain bf16 path's own distance from the twin's plain
    gradient; the bf16 loss within twice that distance plus 1e-3 (one
    scalar: its distance may be near 0 by chance). Returns the
    readings."""
    tag = cfg.name
    kind = "K2" if cfg.family != "ssm" else "K3"
    model = LM(cfg)
    batch = {k: v.cuda() for k, v in SyntheticTokens(
        cfg, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH).batch(0).items()}
    f32 = twin(LM, model, cfg, dtype="float32")
    with attention_as(ops, ref.attention_ref), ssd_as(ops, ref.ssd_chunked):
        loss_p32, g_p32 = grads_of(torch, value_and_grad, f32, batch)
    reset_counts(FA, K, rs, KS)
    loss_k32, g_k32 = grads_of(torch, value_and_grad, f32, batch)
    got = counts(FA, K, rs, KS)
    want = (launches, 0) if kind == "K2" else (0, launches)
    if got != want + (0, 0, 0, 0):
        fail(f"[train] {tag} float32 loss launched K2, K3, K1, EC and UR "
             f"{got} times, expected {want + (0, 0, 0, 0)}")
    worst32 = 0.0
    for k, g in g_k32.items():
        ref_max = float(g_p32[k].abs().max())
        err = leaf_dist(torch, g, g_p32[k])
        if not bool(torch.isfinite(g).all()) or err > F32_MODEL_TOL * ref_max:
            fail(f"[train] {tag} float32 gradient {k}: kernel path "
                 f"{err!r} from the plain path (largest entry {ref_max!r})")
        worst32 = max(worst32, err / max(ref_max, 1e-30))
    if abs(loss_k32 - loss_p32) > F32_MODEL_TOL:
        fail(f"[train] {tag} float32 loss {loss_k32!r} vs plain "
             f"{loss_p32!r}")
    del g_k32, f32
    torch.cuda.empty_cache()
    log(f"[train] {tag} float32 twin, loss and backward at "
        f"{TRAIN_BATCH}x{TRAIN_SEQ}: {launches} {kind} launches; loss "
        f"{loss_k32!r} vs plain {loss_p32!r}; each gradient within "
        f"{worst32!r} of its largest entry of the plain path's (bound "
        f"{F32_MODEL_TOL})")

    with attention_as(ops, ref.attention_ref), ssd_as(ops, ref.ssd_chunked):
        loss_p16, g_p16 = grads_of(torch, value_and_grad, model, batch)
    noise = {k: leaf_dist(torch, g, g_p32[k]) for k, g in g_p16.items()}
    del g_p16
    reset_counts(FA, K, rs, KS)
    loss_k16, g_k16 = grads_of(torch, value_and_grad, model, batch)
    if counts(FA, K, rs, KS) != want + (0, 0, 0, 0):
        fail(f"[train] {tag} bf16 loss launched K2, K3, K1, EC and UR "
             f"{counts(FA, K, rs, KS)} times")
    worst = 0.0
    for k, g in g_k16.items():
        err = leaf_dist(torch, g, g_p32[k])
        if not bool(torch.isfinite(g.float()).all()) or err > 2 * noise[k]:
            fail(f"[train] {tag} bf16 gradient {k}: {err!r} from the float32 "
                 f"twin's, bf16's own distance {noise[k]!r}")
        worst = max(worst, err / max(noise[k], 1e-30))
    lnoise = abs(loss_p16 - loss_p32)
    if abs(loss_k16 - loss_p32) > 2 * lnoise + F32_MODEL_TOL:
        fail(f"[train] {tag} bf16 loss {loss_k16!r}: float32 twin "
             f"{loss_p32!r}, plain bf16 {loss_p16!r}")
    log(f"[train] {tag} bf16, loss and backward at {TRAIN_BATCH}x"
        f"{TRAIN_SEQ}: loss {loss_k16!r} (plain bf16 {loss_p16!r}, float32 "
        f"twin {loss_p32!r}); each gradient's distance from the twin's at "
        f"most {worst!r} times the plain bf16 path's (bound 2)")
    del g_k16, g_p32, model
    torch.cuda.empty_cache()
    return dict(loss=loss_k16, loss_f32=loss_k32, f32_rel=worst32,
                bf16_ratio=worst)


def profile_train_step(torch, G, steps, fn, what):
    """One train step under ``torch.profiler``, its device time split by
    kind: GEMMs, K2, the plain attention backward (inside
    ``KernelGrad.backward``), AdamW's elementwise passes (inside
    ``adamw_update``), other. Returns the split (ms) and the busy share."""
    from torch.profiler import ProfilerActivity, profile, record_function
    back, upd = G.KernelGrad.backward, steps.adamw_update

    def backward(ctx, grad_out):
        with record_function("plain attention backward"):
            return back(ctx, grad_out)

    def adamw(*a, **kw):
        with record_function("adamw"):
            return upd(*a, **kw)

    G.KernelGrad.backward = staticmethod(backward)
    steps.adamw_update = adamw
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
    finally:
        G.KernelGrad.backward, steps.adamw_update = staticmethod(back), upd
    kinds = dict(GEMMs=0.0, K2=0.0, plain_attention_backward=0.0,
                 adamw=0.0, other=0.0)
    by_name = {}

    def within(e, label):
        while e is not None:
            if e.name == label:
                return True
            e = e.cpu_parent
        return False

    for e in prof.events():
        for kern in getattr(e, "kernels", []):
            n = kern.name
            k = "plain_attention_backward" if within(
                e, "plain attention backward") else \
                "adamw" if within(e, "adamw") else \
                "K2" if "attn_tc" in n or "attn_fma" in n else \
                "GEMMs" if any(w in n.lower() for w in (
                    "gemm", "gemv", "nvjet", "xmma", "cutlass")) else "other"
            kinds[k] += kern.duration
            by_name[(k, n)] = by_name.get((k, n), 0.0) + kern.duration
    busy = sum(kinds.values())
    log(f"[profile] {what}: kernels busy {busy / 1e3!r} ms of a "
        f"{wall_us / 1e3!r} ms window (profiler on), busy share "
        f"{busy / wall_us!r}; " + ", ".join(
            f"{k} {v / 1e3!r} ms" for k, v in kinds.items()))
    for (k, n), us in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        log(f"[profile]   {us / 1e3:10.3f} ms  {k:24s} {n[:90]}")
    return {k: v / 1e3 for k, v in kinds.items()}, busy / wall_us


def phase_train_llama(torch, FA, K, rs, KS, G, steps, cfg, LM,
                      SyntheticTokens, adamw_init):
    """llama3.2-3b at full width and depth trained by ``make_train_step``
    (lr 1e-3, 8 x 128 ``SyntheticTokens``): ``TRAIN_STEPS`` steps with a
    finite, falling loss and exactly one K2 launch a layer a step (none of
    K3, K1, EC); ms a step and peak memory; then from the same parameters
    one step with two microbatches against one with one (lr 0, so neither
    moves the parameters): loss and grad norm within 1e-2 relative; a
    profile of one step. Returns the readings."""
    tag = cfg.name
    model = LM(cfg)
    step = steps.make_train_step(model, lr=TRAIN_LR)
    params = dict(model.named_parameters())
    opt = adamw_init(params)
    data = SyntheticTokens(cfg, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, ms = [], []
    for i in range(TRAIN_STEPS):
        batch = data.batch(i)
        reset_counts(FA, K, rs, KS)
        t0 = time.perf_counter()
        _, opt, met = step(params, opt, batch)
        losses.append(float(met["loss"]))
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        if counts(FA, K, rs, KS) != (cfg.layers, 0, 0, 0, 0, 0):
            fail(f"[train] {tag} step {i} launched K2, K3, K1, EC and UR "
                 f"{counts(FA, K, rs, KS)} times, expected "
                 f"{(cfg.layers, 0, 0, 0, 0, 0)}")
    peak = torch.cuda.max_memory_allocated()
    if not all(math.isfinite(x) for x in losses) or \
            not losses[-1] < losses[0]:
        fail(f"[train] {tag}: losses {losses} are not finite and falling")
    log(f"[train] {tag}: {TRAIN_STEPS} steps of make_train_step at "
        f"{TRAIN_BATCH}x{TRAIN_SEQ}, lr {TRAIN_LR}: loss {losses}; "
        f"{cfg.layers} K2 launches a step; ms a step {ms} (host clock, "
        f"ended by reading the loss and a synchronize); peak memory {peak} "
        f"B")
    batch = data.batch(TRAIN_STEPS)
    mets = []
    for mb in (2, 1):
        _, opt, met = steps.make_train_step(model, lr=0.0, microbatches=mb)(
            params, opt, batch)
        mets.append({k: float(v) for k, v in met.items()})
    for k in ("loss", "grad_norm"):
        if abs(mets[0][k] - mets[1][k]) > 1e-2 * abs(mets[1][k]):
            fail(f"[train] {tag}: {k} with two microbatches {mets[0][k]!r} "
                 f"vs one {mets[1][k]!r}")
    log(f"[train] {tag}: two microbatches vs one from the same parameters "
        f"(lr 0): loss {mets[0]['loss']!r} / {mets[1]['loss']!r}, grad norm "
        f"{mets[0]['grad_norm']!r} / {mets[1]['grad_norm']!r} (bound 1e-2 "
        f"relative)")
    split, busy = profile_train_step(
        torch, G, steps, lambda: float(step(params, opt, batch)[2]["loss"]),
        f"{tag} one train step {TRAIN_BATCH}x{TRAIN_SEQ}")
    del model, params, opt, step
    torch.cuda.empty_cache()
    return dict(losses=losses, ms=ms, peak=peak, microbatches=mets,
                profile_ms=split, busy=busy)


def phase_train_cli(torch, FA, K, rs, KS, steps, store, train, sup_mod,
                    cfg, LM, SyntheticTokens, adamw_init):
    """``repro_torch.launch.train.main`` for mamba2-370m at full width
    (``CLI_STEPS`` steps, a checkpoint every ``CLI_EVERY``): a falling
    loss, exactly one K3 launch a layer a step and none of K2, K1 or EC;
    the step-6 checkpoint restores bit-equal to the state it saved; a
    fresh supervisor resumes from step 12 without running a step; steps
    7-12 rerun from the step-6 checkpoint give the first run's losses
    within 1e-3 relative (the embedding's scatter-add is atomic, so not
    bit-deterministic). Prints the seconds a save and a restore. Returns
    the readings."""
    import shutil
    import tempfile
    tag = cfg.name
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    free = shutil.disk_usage(tmp).free
    snaps, saves = {}, []

    class Recording(store.CheckpointManager):
        """Keeps a copy on the card of the state each save wrote."""

        def save(self, step, tree, extra=None):
            snaps[step] = {k: v.detach().clone()
                           for k, v in store._flatten(tree)}
            t0 = time.perf_counter()
            path = super().save(step, tree, extra)
            saves.append(time.perf_counter() - t0)
            return path

    real = train.CheckpointManager
    train.CheckpointManager = Recording
    reset_counts(FA, K, rs, KS)
    try:
        t0 = time.perf_counter()
        state = train.main(["--arch", tag, "--steps", str(CLI_STEPS),
                            "--ckpt-every", str(CLI_EVERY), "--ckpt-dir",
                            tmp], device="cuda")
        secs = time.perf_counter() - t0
        got = counts(FA, K, rs, KS)
        hist = state["history"]
        want = (0, cfg.layers * CLI_STEPS, 0, 0, 0, 0)
        if got != want or len(hist) != CLI_STEPS:
            fail(f"[train] {tag} CLI: {len(hist)} steps launched K2, K3, K1, "
                 f"EC and UR {got} times, expected {CLI_STEPS} and {want}")
        if not hist[-1] < hist[0]:
            fail(f"[train] {tag} CLI: the loss did not fall: {hist}")
        size = sum(os.path.getsize(os.path.join(d, f))
                   for d, _, fs in os.walk(os.path.join(
                       tmp, f"step_{CLI_EVERY:010d}")) for f in fs)
        log(f"[train] {tag} CLI: {CLI_STEPS} steps at {TRAIN_BATCH}x"
            f"{TRAIN_SEQ} in {secs!r} s (checkpoints included), "
            f"{cfg.layers} K3 launches a step; loss {hist}; saves {saves} "
            f"s for {size} B each ({free} B free on the disk)")
        live = dict(params=state["params"], opt=state["opt"])
        t0 = time.perf_counter()
        store.load_checkpoint(tmp, live, step=CLI_EVERY)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        for k, v in store._flatten(live):
            if not torch.equal(v, snaps[CLI_EVERY][k]):
                fail(f"[train] {tag}: {k} restored from step {CLI_EVERY} "
                     f"differs from the state that was saved")
        del state, live, snaps[CLI_EVERY]
    finally:
        train.CheckpointManager = real

    model = LM(cfg)
    step = steps.make_train_step(model, lr=TRAIN_LR)
    params = dict(model.named_parameters())
    fresh = dict(params=params, opt=adamw_init(params))
    data = SyntheticTokens(cfg, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH)
    reset_counts(FA, K, rs, KS)
    sup = sup_mod.TrainSupervisor(step, data.batch,
                                  store.CheckpointManager(tmp, keep=3),
                                  ckpt_every=CLI_EVERY)
    resumed = sup.run(fresh, 0, CLI_STEPS)
    if resumed["history"] or K.launches:
        fail(f"[train] {tag}: a fresh supervisor re-ran "
             f"{len(resumed['history'])} steps ({K.launches} K3 launches) "
             f"after the step-{CLI_STEPS} checkpoint")
    for k, v in store._flatten(dict(params=resumed["params"],
                                    opt=resumed["opt"])):
        if not torch.equal(v, snaps[CLI_STEPS][k]):
            fail(f"[train] {tag}: {k} resumed from step {CLI_STEPS} differs "
                 f"from the state that was saved")
    snaps.clear()
    shutil.rmtree(os.path.join(tmp, f"step_{CLI_STEPS:010d}"))
    sup = sup_mod.TrainSupervisor(step, data.batch,
                                  store.CheckpointManager(tmp, keep=3),
                                  ckpt_every=CLI_EVERY)
    rerun = sup.run(fresh, 0, CLI_STEPS)["history"]
    first = hist[CLI_EVERY:]
    rel = max(abs(a - b) / abs(b) for a, b in zip(rerun, first))
    if len(rerun) != CLI_STEPS - CLI_EVERY or rel > 1e-3:
        fail(f"[train] {tag}: steps {CLI_EVERY + 1}-{CLI_STEPS} rerun from "
             f"the step-{CLI_EVERY} checkpoint give {rerun}, the first run "
             f"{first}")
    log(f"[train] {tag}: step {CLI_EVERY} restored bit-equal to the saved "
        f"state ({restore_s!r} s); a fresh supervisor resumed from step "
        f"{CLI_STEPS} with no step run and the saved state; steps "
        f"{CLI_EVERY + 1}-{CLI_STEPS} rerun from step {CLI_EVERY}: losses "
        f"within {rel!r} relative of the first run's (bound 1e-3)")
    del model, params, fresh, step, resumed, sup
    shutil.rmtree(tmp)
    torch.cuda.empty_cache()
    return dict(losses=hist, secs=secs, save_s=saves, ckpt_bytes=size,
                restore_s=restore_s, rerun_rel=rel)


SHARDED_STEPS = 3                      # [sharded]: llama3.2-3b steps
SHARDED_TOL = 1e-2                     # (n, 2) ranks against one device
DRYRUNS = (("llama3.2-3b", "train_4k"),
           ("mamba2-370m", "train_4k", "--multi-pod"))
MATMULS = ("aten::mm", "aten::addmm", "aten::bmm", "aten::baddbmm")


def start_dryruns(tmp):
    """Start the ``[dryrun]`` subprocesses (``python -m
    repro_torch.launch.dryrun``, CPU only: CUDA hidden, one thread each) so
    that they run beside the card's phases: the two production cells of
    ``DRYRUNS`` and the ``[sharded]`` cell (1 x 1, llama3.2-3b, 8 x 128
    train). Returns ``{name: (Popen, output path)}``; ``stop`` ends them."""
    import subprocess as sp
    env = dict(os.environ, PYTHONPATH=SRC, CUDA_VISIBLE_DEVICES="",
               OMP_NUM_THREADS="1")
    cells = [dict(name=f"{c[0]} {c[1]}" + (" multi-pod" if c[2:] else ""),
                  argv=["--arch", c[0], "--shape", c[1], *c[2:]])
             for c in DRYRUNS]
    cells.append(dict(name="sharded cell", argv=[
        "--arch", "llama3.2-3b", "--shape", "train_4k", "--mesh", "1x1",
        "--batch", str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ)]))
    out = {}
    for c in cells:
        path = os.path.join(tmp, c["name"].replace(" ", "_") + ".log")
        f = open(path, "w")
        out[c["name"]] = (sp.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", *c["argv"]],
            stdout=f, stderr=sp.STDOUT, env=env, cwd=ROOT), path, f)
    return out


def stop(procs):
    for p, _, f in procs.values():
        if p.poll() is None:
            p.kill()
        p.wait()
        f.close()


def sharded_rank(rank, world, model_axis, store, out, backend="nccl",
                 device="cuda", cfg_name="llama3.2-3b", smoke=False):
    """One rank of ``[sharded]``: ``SHARDED_STEPS`` steps of
    ``make_train_step`` on a ``(world // model_axis, model_axis)`` mesh,
    params, moments and batches placed by ``param_shardings``,
    ``opt_shardings`` and ``batch_shardings``; K2, K3, K1, EC and UR
    launches a step; ms a step; the bytes of params, moments and batch as
    allocated; the peak memory; the final parameters gathered to the host.
    With ``world`` 1 the same steps then run unsharded from the same seed-0
    weights (the sharded run freed first), one more unsharded step under
    ``torch.profiler`` with ``with_flops``, and rank 0 writes both runs to
    ``out.json``."""
    import torch
    import torch.distributed as dist
    sys.path.insert(0, SRC)
    from torch.distributed.device_mesh import init_device_mesh
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.core import kernelsim as KS
    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.device import round_step as rs
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ssd_scan as K
    from repro_torch.models.model import LM
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.runtime import steps

    if device == "cuda":
        torch.cuda.set_device(rank)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group(backend, store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    cfg = get_config(cfg_name)
    cfg = cfg.smoke() if smoke else cfg
    data = SyntheticTokens(cfg, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH)
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)

    def nbytes(t):
        t = t.to_local() if hasattr(t, "to_local") else t
        return t.numel() * t.element_size()

    def run(mesh):
        model = LM(cfg, device=device)
        step = steps.make_train_step(model, lr=TRAIN_LR)
        params = dict(model.named_parameters())
        opt = adamw_init(params)
        if mesh is not None:
            params = steps.place_params(
                model, steps.param_shardings(mesh, model, params))
            opt = steps.place(adamw_init(params),
                              steps.opt_shardings(mesh, model, params))
        res = dict(loss=[], grad_norm=[], ms=[], launches=[])
        if device == "cuda":
            sync()
            torch.cuda.reset_peak_memory_stats()
        for i in range(SHARDED_STEPS):
            batch = data.batch(i)
            if mesh is not None:
                batch = steps.place(batch, steps.batch_shardings(
                    mesh, cfg, batch))
            if i == 0:
                res["argument_bytes"] = sum(nbytes(t) for t in (
                    *params.values(), *opt["mu"].values(),
                    *opt["nu"].values(), opt["step"], *batch.values()))
            reset_counts(FA, K, rs, KS)
            sync()
            t0 = time.perf_counter()
            _, opt, met = step(params, opt, batch)
            res["loss"].append(float(met["loss"]))
            res["grad_norm"].append(float(met["grad_norm"]))
            sync()
            res["ms"].append((time.perf_counter() - t0) * 1e3)
            res["launches"].append(list(counts(FA, K, rs, KS)))
        if device == "cuda":
            res["peak"] = torch.cuda.max_memory_allocated()
        final = {k: (p.full_tensor() if hasattr(p, "full_tensor") else p)
                 .detach().to("cpu", copy=True) for k, p in params.items()}
        if mesh is None:
            batch = data.batch(SHARDED_STEPS)
            sync()
            with profile(activities=[ProfilerActivity.CPU],
                         with_flops=True) as prof:
                step(params, opt, batch)
                sync()
            res["profiler_flops"] = sum(
                e.flops for e in prof.key_averages() if e.key in MATMULS)
        del model, step, params, opt, batch
        if device == "cuda":
            torch.cuda.empty_cache()
        return res, final

    try:
        mesh = init_device_mesh(device, (world // model_axis, model_axis),
                                mesh_dim_names=("data", "model"))
        sharded, final = run(mesh)
        res = dict(sharded=sharded)
        if world == 1:
            plain, plain_final = run(None)
            res["plain"] = plain
            res["params_equal"] = all(torch.equal(final[k], plain_final[k])
                                      for k in final)
            res["params"] = len(final)
    finally:
        dist.destroy_process_group()
    if rank == 0:
        with open(f"{out}.json", "w") as f:
            json.dump(res, f)


def spawn_ranks(fn, world, args, what, timeout=600):
    """``fn(rank, world, *args, store, out)`` in ``world`` spawned ranks;
    fails on a rank that does not exit 0; returns rank 0's JSON."""
    import multiprocessing as mp
    import tempfile
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "rank")
        procs = [ctx.Process(target=fn, args=(
            r, world, *args[:1], os.path.join(tmp, "store"), out,
            *args[1:])) for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
        codes = [p.exitcode for p in procs]
        if codes != [0] * world:
            fail(f"[{what}] rank exit codes {codes}")
        with open(f"{out}.json") as f:
            return json.load(f)


def phase_sharded(torch, layers, backend="nccl", device="cuda", count=None,
                  **kw):
    """llama3.2-3b at full width and depth, 8 x 128, on a 1 x 1
    ``("data", "model")`` mesh in one spawned NCCL rank: ``SHARDED_STEPS``
    steps on DTensors, then the same steps unsharded from the same weights.
    Gates: losses, grad norms and final parameters bit-equal; exactly one K2
    launch a layer a sharded step, none of K3, K1 or EC. With two GPUs or
    more, ``(count // 2, 2)`` NCCL ranks run the sharded steps too, their
    losses within ``SHARDED_TOL`` relative of the one-device losses; on one
    GPU that part is not run, and a line says so. ``backend``, ``device``,
    ``count`` (the cards) and ``kw`` (``cfg_name``, ``smoke``) let a CPU
    rehearsal run it on gloo. Returns the readings."""
    t0 = time.perf_counter()
    res = spawn_ranks(sharded_rank, 1, (1, backend, device, *kw.values()),
                      "sharded")
    sh, pl = res["sharded"], res["plain"]
    want = [layers, 0, 0, 0, 0, 0]
    if any(n != want for n in sh["launches"]):
        fail(f"[sharded] launches (K2, K3, K1 x2, EC, UR) a step "
             f"{sh['launches']}, expected {want} each step")
    for k in ("loss", "grad_norm"):
        if sh[k] != pl[k]:
            fail(f"[sharded] {k} on the 1 x 1 mesh {sh[k]} is not bit-equal "
                 f"to the unsharded step's {pl[k]}")
    if not res["params_equal"]:
        fail("[sharded] final parameters on the 1 x 1 mesh differ from the "
             "unsharded step's")
    log(f"[sharded] 1 x 1 mesh, {SHARDED_STEPS} steps at {TRAIN_BATCH}x"
        f"{TRAIN_SEQ}: losses {sh['loss']} and grad norms {sh['grad_norm']} "
        f"bit-equal to the unsharded step's, all {res['params']} final "
        f"parameters bit-equal; {layers} K2 launches a sharded step, none of "
        f"K3, K1, EC; ms a step sharded {sh['ms']} against unsharded "
        f"{pl['ms']} (host clock ended by a synchronize); peak "
        f"{sh.get('peak')} B sharded, {pl.get('peak')} B unsharded; "
        f"argument bytes {sh['argument_bytes']}")
    res["overhead_ms"] = min(sh["ms"][1:]) - min(pl["ms"][1:]) \
        if len(sh["ms"]) > 1 else None
    if count is None:
        count = torch.cuda.device_count() if device == "cuda" else 1
    if count < 2:
        log(f"[sharded] (n, 2) NCCL ranks not run: {count} GPU visible, "
            f"and NCCL cannot put two ranks on one GPU; the multi-rank step "
            f"is held on four gloo ranks by tests/test_torch_sharding.py")
        res["multi"] = None
    else:
        world = (count // 2) * 2
        multi = spawn_ranks(sharded_rank, world, (2, backend, device,
                                                  *kw.values()),
                            "sharded")["sharded"]
        rel = max(abs(a - b) / abs(b) for a, b in zip(multi["loss"],
                                                       pl["loss"]))
        if rel > SHARDED_TOL:
            fail(f"[sharded] ({world // 2}, 2) ranks' losses "
                 f"{multi['loss']} vs one device {pl['loss']}: {rel!r} > "
                 f"{SHARDED_TOL}")
        if any(n != want for n in multi["launches"]):
            fail(f"[sharded] ({world // 2}, 2) ranks: rank 0's launches a "
                 f"step {multi['launches']}, expected {want}")
        log(f"[sharded] ({world // 2}, 2) {backend} ranks: losses "
            f"{multi['loss']} within {rel!r} of one device's (bound "
            f"{SHARDED_TOL}); rank 0's launches a step {multi['launches']}; "
            f"ms a step {multi['ms']}; rank 0's peak {multi.get('peak')} B")
        res["multi"] = multi
    res["secs"] = time.perf_counter() - t0
    log(f"[sharded] phase time {res['secs']:.1f} s")
    return res


def phase_dryrun(procs, sharded, layers, attn_flops):
    """Waits for the ``start_dryruns`` subprocesses and prints each record.
    The ``[sharded]`` cell's record: ``argument_bytes`` equal to the bytes
    of params, moments and batch that the card allocated; ``flops`` less
    K2's formula (the profiler sees no ctypes launch) within 1e-3 relative
    of ``torch.profiler``'s matmul FLOPs for the same step (the unsharded
    twin: on a mesh the profiler counts each product twice, at the DTensor
    op and at its local op); ``peak_bytes`` beside
    ``torch.cuda.max_memory_allocated()``, a reading. Returns the
    records."""
    t0 = time.perf_counter()
    recs = {}
    for name, (p, path, f) in procs.items():
        try:
            rc = p.wait(timeout=max(1.0, 900 - (time.perf_counter() - t0)))
        except subprocess.TimeoutExpired:
            stop(procs)
            fail(f"[dryrun] {name} did not finish")
        f.flush()
        with open(path) as fh:
            text = fh.read()
        if rc != 0:
            fail(f"[dryrun] {name} exited {rc}: {text[-3000:]}")
        rec = json.loads(text.strip().splitlines()[-1])
        recs[name] = rec
        log(f"[dryrun] {name}: {json.dumps(rec)}")
    stop(procs)
    rec = recs["sharded cell"]
    card = sharded["sharded"]["argument_bytes"]
    if rec["memory"]["argument_bytes"] != card:
        fail(f"[dryrun] sharded cell argument_bytes "
             f"{rec['memory']['argument_bytes']} != {card} allocated on the "
             f"card")
    seen = rec["flops"] - layers * attn_flops
    prof = sharded["plain"]["profiler_flops"]
    if abs(seen - prof) > 1e-3 * prof:
        fail(f"[dryrun] sharded cell flops less K2's ({seen!r}) vs "
             f"torch.profiler's matmul FLOPs {prof!r}")
    log(f"[dryrun] sharded cell: argument_bytes {card} equal to the card's "
        f"allocation; flops {rec['flops']!r} ({seen!r} without K2's "
        f"{layers} x {attn_flops!r}) against the profiler's {prof!r} "
        f"(bound 1e-3 relative); peak_bytes {rec['memory']['peak_bytes']} "
        f"beside the card's max_memory_allocated "
        f"{sharded['sharded'].get('peak')} B")
    return recs


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
    dry_tmp = tempfile.mkdtemp(prefix="chip_smoke_dryrun_")
    dryruns = start_dryruns(dry_tmp)
    atexit.register(stop, dryruns)
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
    ex, x, lay, plc, launches, subrounds, steps_on_main, unpacks, secs = \
        phase_main(torch, rs, api, T)
    if K.launches or FA.launches:
        fail(f"the broadcast path launched ssd_scan {K.launches} and "
             f"flash_attention {FA.launches} times")
    phase_small(torch, api, T, DeviceConfig, SimConfig)
    tm = phase_timing(np, torch, rs, runner, ex, x, lay, plc, rate, secs)
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
    root = ex.root
    del ex, x
    torch.cuda.empty_cache()
    ur = phase_inplace_copies(torch, runner, plc, root, rate)
    ur.update(phase_unpack(torch, runner, lay, rate))
    ur_head, fill = ur[MAIN_TAIL], ur[MAIN_FILL]
    staged = ur[UNPACK_SHAPES[0][0]]
    log(f"[summary] {name}: UR on the main path (each device's "
        f"{ur_head['tail']} B tail): {ur_head['ms']!r} ms, "
        f"{ur_head['share_of_bound']!r} of its {ur_head['bound_ms']!r} ms "
        f"bound; its fill_inplace {fill['ms']!r} ms, "
        f"{fill['share_of_bound']!r} of {fill['bound_ms']!r} ms; staged at "
        f"{UNPACK_SHAPES[0][0]} 128e6 B, 256 devices: {staged['ms']!r} ms, "
        f"{staged['share_of_bound']!r} of its {staged['bound_ms']!r} ms "
        f"bound; unpack_ref {staged['plain_ms']!r} ms; unpack_rows "
        f"{regs['unpack_rows']}")
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
        f"{sw['ms']!r} ms in one launch ({sw['us_per_step']!r} us a step) "
        f"against {sw['numpy_ms']!r} ms for the numpy engine; mesh2d 16x16 "
        f"srda x {pl['lanes']} lanes {pl['ms']!r} ms (plain "
        f"{pl['plain_ms']!r} ms, numpy {pl['numpy_ms']!r} ms); 64x64 glf "
        f"{ec['glf']['ms']!r} ms, bine {ec['bine']['ms']!r} ms (numpy "
        f"{ec['bine']['numpy_ms']!r}), srda {ec['srda']['ms']!r} ms (numpy "
        f"{ec['srda']['numpy_ms']!r}); held to " + ", ".join(
            f"{k} {ec[k]['held_to']}" for k in ("plain", "sweep", "glf",
                                                "bine", "srda")) +
        f"; step floor {ec['floor_us_per_step']!r} us")
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
    del dense
    torch.cuda.empty_cache()

    fam = {}
    t_fam = time.perf_counter()
    for arch, k2, k3, twin_layers in FAMILIES:
        fam[arch] = phase_family(torch, FA, K, KS, rs, ref, ops, serve,
                                 get_config(arch), LM, SyntheticTokens, k2,
                                 k3, twin_layers, name)
    fam_secs = time.perf_counter() - t_fam
    for arch, r in fam.items():
        log(f"[summary] {name}: {arch} prefill 4x2048 {r['prefill_ms']!r} ms "
            f"({r['k2']} K2, {r['k3']} K3 launches), peak {r['peak']} B; "
            f"decode {r['decode_ms']!r} ms per step; phase {r['secs']:.1f} s")
    log(f"[summary] the four family phases took {fam_secs:.1f} s")

    from repro_torch.checkpoint import store
    from repro_torch.kernels import grad as G
    from repro_torch.launch import train
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.runtime import steps
    from repro_torch.runtime import supervisor as sup_mod
    t_train = time.perf_counter()
    phase_train_grad(torch, FA, K, ref)
    mcfg = get_config("mamba2-370m")
    tloss = {c.name: phase_train_loss(torch, FA, K, rs, KS, ref, ops, c, LM,
                                      SyntheticTokens, steps.value_and_grad,
                                      c.layers)
             for c in (dcfg, mcfg)}
    tr = phase_train_llama(torch, FA, K, rs, KS, G, steps, dcfg, LM,
                           SyntheticTokens, adamw_init)
    cli = phase_train_cli(torch, FA, K, rs, KS, steps, store, train, sup_mod,
                          mcfg, LM, SyntheticTokens, adamw_init)
    train_secs = time.perf_counter() - t_train
    log(f"[summary] {name}: training llama3.2-3b {TRAIN_BATCH}x{TRAIN_SEQ} "
        f"at full width and depth: {min(tr['ms'][1:])!r} ms a step (least "
        f"of steps 2-{TRAIN_STEPS}), peak {tr['peak']} B, loss "
        f"{tr['losses'][0]!r} -> {tr['losses'][-1]!r}, {dcfg.layers} K2 "
        f"launches a step; one step by kind (ms) {tr['profile_ms']}; "
        f"mamba2-370m through the CLI: {CLI_STEPS} steps in "
        f"{cli['secs']!r} s, loss {cli['losses'][0]!r} -> "
        f"{cli['losses'][-1]!r}, {mcfg.layers} K3 launches a step, a save "
        f"{cli['save_s']} s for {cli['ckpt_bytes']} B, a restore "
        f"{cli['restore_s']!r} s; the [train] section took "
        f"{train_secs:.1f} s")
    train_res = dict(loss_grads=tloss, llama=tr, cli=cli, secs=train_secs)

    from repro_torch.models.layers import padded_heads
    from repro_torch.runtime.cost import attention_cost
    t_new = time.perf_counter()
    sharded = phase_sharded(torch, dcfg.layers)
    hq, hkv, _ = padded_heads(dcfg)
    attn_flops = attention_cost(
        torch.empty((TRAIN_BATCH, hq, TRAIN_SEQ, dcfg.hd), device="meta"),
        torch.empty((TRAIN_BATCH, hkv, TRAIN_SEQ, dcfg.hd),
                    device="meta"))[0]
    t_dry = time.perf_counter()
    dry = phase_dryrun(dryruns, sharded, dcfg.layers, attn_flops)
    log(f"[summary] {name}: sharded llama3.2-3b on a 1 x 1 mesh "
        f"{min(sharded['sharded']['ms'][1:])!r} ms a step against "
        f"{min(sharded['plain']['ms'][1:])!r} unsharded (least of steps "
        f"2-{SHARDED_STEPS}; DTensor overhead {sharded['overhead_ms']!r} ms), "
        f"bit-equal; the dry-run records waited "
        f"{time.perf_counter() - t_dry:.1f} s after [sharded]; the two "
        f"phases took "
        f"{time.perf_counter() - t_new:.1f} s")
    train_k2 = {f"{dcfg.name} train step": dcfg.layers,
                f"{dcfg.name} loss {TRAIN_BATCH}x{TRAIN_SEQ}": dcfg.layers}
    train_k3 = {f"{mcfg.name} train step (CLI)": mcfg.layers,
                f"{mcfg.name} loss {TRAIN_BATCH}x{TRAIN_SEQ}": mcfg.layers}
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
        # the runner's copy out; launches: on the main path, a broadcast
        # (the in-place tail), whose shape ms, plain_ms, library_ms,
        # flat_copy_ms and bound_ms read; "shapes" every shape held and
        # timed, the staged copy out's among them
        "name": "unpack_rows", "route": "cuda",
        "source": "src/repro_torch/csrc/unpack_rows.cu",
        "replaces": None,
        "reference_op": "src/repro/device/runner.py:136 (an XLA slice)",
        "launches": unpacks, "bad_bytes": 0,
        "ms": ur_head["ms"], "plain_ms": ur_head["plain_ms"],
        "bound_ms": ur_head["bound_ms"], "bound_by": "bytes",
        "library_ms": ur_head["library_ms"],
        "flat_copy_ms": ur_head["flat_copy_ms"], "shape": MAIN_TAIL,
        "shapes": ur, **regs["unpack_rows"],
    }, {
        # the in-place layout's start, in the same library; launches: on
        # the main path, one a broadcast (gated in [main])
        "name": "fill_inplace", "route": "cuda",
        "source": "src/repro_torch/csrc/unpack_rows.cu",
        "replaces": None,
        "reference_op": "src/repro/device/runner.py (the packet buffers' "
                        "zero fill and the root's payload)",
        "launches": 1, "bad_bytes": 0,
        "ms": fill["ms"], "plain_ms": fill["plain_ms"],
        "bound_ms": fill["bound_ms"], "bound_by": "bytes",
        "library_ms": fill["library_ms"],
        "flat_copy_ms": fill["flat_copy_ms"], "shape": MAIN_FILL,
        **regs["fill_inplace"],
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
        "launches_by_family": {"llama3.2-3b": dpf["launches"], **{
            arch: r["k2"] for arch, r in fam.items()}},
        "launches_by_path": {**train_k2, f"{dcfg.name} sharded train "
                             f"step (1 x 1 mesh)": dcfg.layers},
        "backward": "plain recompute: attention_ref under autograd "
                    "(kernels/grad.py KernelGrad)",
        "new_shapes": at["new_shapes"],
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
        "launches_by_family": {"mamba2-370m": pf["launches"], **{
            arch: r["k3"] for arch, r in fam.items() if r["k3"]}},
        "launches_by_path": train_k3,
        "backward": "plain recompute: ssd_chunked under autograd "
                    "(kernels/grad.py KernelGrad)",
        "zamba2": st["zamba2"],
    }, {
        # ms, plain_ms, numpy_ms and bound_ms at the lanes held against
        # the plain version (mesh2d 16 x 16 srda, 12 sizes);
        # "sweep" (mesh2d 32 x 32 srda, 12 sizes), "glf", "bine" and "srda"
        # (mesh2d 64 x 64, one lane) the other shapes of the main path;
        # floor_us_per_step the design's step on a chain of tasks
        "name": "event_core", "route": "cuda",
        "source": "src/repro_torch/csrc/event_core.cu",
        "replaces": "src/repro/core/kernelsim.py:121",
        "launches": ec["launches"], "mismatches": pl["mismatches"],
        "max_abs_err": pl["max_abs_err"],
        "ms": pl["ms"], "plain_ms": pl["plain_ms"],
        "numpy_ms": pl["numpy_ms"], "bound_ms": pl["bound_ms"],
        "bound_by": "bytes", "limited_by": "latency of 2n dependent steps",
        "library_ms": None, "steps": pl["steps"], "lanes": pl["lanes"],
        "tasks": pl["tasks"],
        "floor_us_per_step": ec["floor_us_per_step"],
        **{key: {k: ec[key][k] for k in (
            "tasks", "lanes", "steps", "ms", "us_per_step", "variants_ms",
            "prep_ms", "memory", "numpy_ms", "plain_ms", "held_to",
            "bound_ms")} for key in ("sweep", "glf", "bine", "srda")},
        **regs["event_core"],
    }]
    log(f"[summary] the whole run took {time.perf_counter() - t_start:.1f} s "
        f"after the imports")
    print(json.dumps({"calibration": cal}), flush=True)
    print(json.dumps({"distributed": dist_res}), flush=True)
    print(json.dumps({"families": fam}), flush=True)
    print(json.dumps({"train": train_res}), flush=True)
    print(json.dumps({"sharded": sharded, "dryrun": dry}), flush=True)
    print(name, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
