"""Port tests that need an NVIDIA GPU (marker ``cuda``): the hand-written
round-step kernel against its plain PyTorch version, and small broadcasts on
the card against the same broadcasts on the CPU. They skip on a host without
a GPU; on the card run them with

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
    before = rs.launches
    out = ex.run(x)
    assert rs.launches - before == ex.num_launches
    cpu = model.executable(root=3, nbytes=6000, algo=algo, config=SimConfig(
        device=DeviceConfig(device="cpu"))).run(x)
    assert torch.equal(out.cpu().view(torch.int16), cpu.view(torch.int16))
    assert ex.verify(x).ok
