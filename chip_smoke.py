#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which exits non-zero on failure:

1. build every CUDA kernel of the main path with ``nvcc`` (sm_90a);
2. hold each kernel bit-exact against its plain PyTorch version on the card:
   random tables with every edge case, float32 and bfloat16 payloads, and a
   buffer over 2**31 bytes;
3. the main path: ``repro_torch.api.compile(mesh2d(16, 16)).executable(
   root=0, nbytes=16 MiB)`` on cuda -- 256 virtual devices, verified bit-exact
   on every device, with the kernel's launch count equal to d x cycles;
4. small cases (ring 8, hypercube 3; bbs and bine_tree; roots 0 and 3;
   bfloat16) on the card, each verified and held against the CPU run;
5. timing at the main-path shape: the kernel per launch (a CUDA graph of the
   whole cycle loop, so host launch cost is left out), its bound (bytes
   moved over the card's memory rate), the plain version and the
   ``index_select``/``index_copy_`` yardstick.

The last lines are the card (``nvidia-smi`` name and power limit), one JSON
line per kernel, and ``{"ok": true, "device": {...}}``. Without a GPU, or
without the repo beside it, it exits non-zero and prints no result.
"""

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")
MAIN_NBYTES = 16 << 20
# HBM rates of the SXM data sheets (bytes/s), by the name nvidia-smi reports
MEM_RATE = (("H200", 4.8e12), ("H100", 3.35e12))


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


def phase_build():
    from repro_torch import nvcc
    t0 = time.perf_counter()
    nvcc.build(["permute_step"])
    log(f"[build] permute_step built in {time.perf_counter() - t0:.3f} s")
    for line in nvcc.build_log("permute_step").splitlines():
        if "registers" in line or "spill" in line:
            log(f"[build]   {line.strip()}")


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
    rs.launches = 0
    t0 = time.perf_counter()
    chk = ex.verify(x)
    torch.cuda.synchronize()
    t_verify = time.perf_counter() - t0
    launches = rs.launches
    out = ex.run(x)
    if tuple(out.shape) != (256,) + tuple(x.shape) or \
            not torch.isfinite(out).all() or not torch.equal(out[255], x):
        fail(f"main path output: shape {tuple(out.shape)}, or non-finite or "
             f"unequal values")
    del out
    if not chk.ok:
        fail(f"main path: devices {chk.missing[:16]} differ from the payload")
    if launches != ex.num_launches:
        fail(f"main path launched permute_step {launches} times, expected "
             f"d x cycles = {ex.num_launches}")
    from repro_torch.device import runner
    lay = runner.packet_layout(x, s, ex.num_groups)
    secs = ex.measure(x, reps=3)
    log(f"[main] mesh2d 16x16, {MAIN_NBYTES} B float32 from root 0: "
        f"candidate {ex.candidate}, K={s.K}, m={ex.num_groups}, d={s.d}, "
        f"cycles={s.num_cycles(ex.num_groups)}, relay rows={s.num_relay}, "
        f"launches={launches}, packet buffer {lay.buffer_bytes} B "
        f"({lay.rows} rows x {lay.row_bytes} B x {lay.n} devices)")
    log(f"[main] plan+tables build {t_build:.3f} s; verify (run + compare) "
        f"{t_verify:.3f} s; ok on all {len(chk.required)} devices")
    return ex, x, lay, launches, secs


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
                    f"the CPU run ({ex.candidate}, {ex.num_launches} "
                    f"launches)")


def phase_timing(np, torch, rs, runner, ex, x, lay, rate):
    """Per-launch times over the main path's whole cycle loop."""
    dev = torch.device("cuda")
    tabs = ex.tables()
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
    bound_ms = nbytes / rate * 1e3 / nl

    buf = runner.pack(x, lay, ex.root, dev)
    for t in flat_tabs[:d]:                       # warm-up
        rs.permute_step(buf, t)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for t in flat_tabs:
            rs.permute_step(buf, t)
    graph.replay()
    kernel_ms = min(cuda_ms(graph.replay) for _ in range(3)) / nl
    eager_ms = min(cuda_ms(lambda: runner.run_cycles(buf, tabs))
                   for _ in range(2)) / nl

    plain_ms = cuda_ms(lambda: [rs.permute_step_ref(buf, t)
                                for t in flat_tabs]) / nl

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
    library_ms = min(cuda_ms(library) for _ in range(2)) / nl
    del graph, buf, flat
    return dict(ms=kernel_ms, eager_ms=eager_ms, plain_ms=plain_ms,
                library_ms=library_ms, bound_ms=bound_ms, bytes=nbytes,
                launches_timed=nl)


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
    from repro_torch.device import round_step as rs
    from repro_torch.device import runner

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = card()
    log(f"[card] {name}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    rate = mem_rate(name)

    phase_build()
    max_err = phase_kernel_vs_plain(np, torch, rs)
    ex, x, lay, launches, secs = phase_main(torch, rs, api, T)
    phase_small(torch, api, T, DeviceConfig, SimConfig)
    tm = phase_timing(np, torch, rs, runner, ex, x, lay, rate)
    moved = tm["bytes"]
    log(f"[main] measure(): {secs * 1e3:.4f} ms per broadcast (eager launch "
        f"loop, min of 3), {moved} B moved by the kernel = "
        f"{moved / secs / 1e9:.2f} GB/s effective; payload delivered to 255 "
        f"devices = {255 * MAIN_NBYTES / secs / 1e9:.2f} GB/s")
    log(f"[timing] permute_step per launch over the {tm['launches_timed']} "
        f"launches: kernel {tm['ms'] * 1e3:.3f} us (CUDA graph), eager "
        f"loop {tm['eager_ms'] * 1e3:.3f} us, bound {tm['bound_ms'] * 1e3:.3f}"
        f" us ({tm['bytes'] / tm['launches_timed']:.0f} B per launch at "
        f"{rate / 1e12:.2f} TB/s), plain {tm['plain_ms'] * 1e3:.3f} us, "
        f"index_select+index_copy_ {tm['library_ms'] * 1e3:.3f} us")
    kernels = [{
        "name": "permute_step", "route": "cuda",
        "source": "src/repro_torch/csrc/permute_step.cu",
        "replaces": "src/repro/device/pallas_step.py:46",
        "launches": launches, "max_abs_err": max_err,
        "ms": tm["ms"], "plain_ms": tm["plain_ms"],
        "bound_ms": tm["bound_ms"], "bound_by": "bytes",
        "library_ms": tm["library_ms"],
    }]
    print(name, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
