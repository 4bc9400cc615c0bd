"""The PyTorch port stands alone and runs where it is told.

Nothing under ``src/repro_torch/`` or ``chip_smoke.py`` imports jax, jaxlib or
the JAX package ``repro``; the entry points default to cuda and raise on a
host without a GPU instead of carrying on on the CPU; the config blocks and
stubs the slice changed behave as documented.
"""

import ast
import os

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "src", "repro_torch")
FORBIDDEN = ("jax", "jaxlib", "repro")


def _port_files():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for d, _, files in os.walk(PORT):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _imported(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_port_imports_no_jax_and_no_reference(path):
    bad = [m for m in _imported(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path} imports {bad}"


def test_executable_defaults_to_cuda_and_raises_without_gpu(monkeypatch):
    from repro_torch import api
    from repro_torch.core import topology as T
    from repro_torch.core.simconfig import DeviceConfig

    assert DeviceConfig().device == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = api.compile(T.ring(8))
    with pytest.raises(RuntimeError, match="cuda"):
        model.executable(root=0, nbytes=4096)
    with pytest.raises(RuntimeError, match="cuda"):
        model.executable(root=0, nbytes=4096, algo="binomial")


def test_runners_raise_on_cuda_without_gpu(monkeypatch):
    from repro_torch.device import runner

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = torch.arange(16, dtype=torch.float32)
    with pytest.raises(RuntimeError):
        runner.binomial_broadcast(x, 8)
    with pytest.raises(RuntimeError):
        runner.chain_broadcast(x, 8)


def test_cuda_tensor_never_takes_the_plain_path():
    """On a non-CPU tensor the wrapper launches the kernel or raises; here a
    ``meta`` tensor stands in for a device without the kernel."""
    from repro_torch.device.round_step import permute_step

    buf = torch.empty((2, 3, 16), dtype=torch.uint8, device="meta")
    tab = torch.empty((5, 2), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        permute_step(buf, tab)


def test_rounds_never_take_the_plain_path_off_the_cpu():
    """``permute_rounds`` on a ``meta`` buffer (a device without the
    kernel) raises; it does not run the plain version."""
    from repro_torch.device import round_step as rs

    moves = rs.compact_moves(np.stack([rs.random_table(
        np.random.default_rng(0), 2, 3) for _ in range(4)]), 3)
    buf = torch.empty((2, 3, 16), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        rs.permute_rounds(buf, moves.to("meta"))
    with pytest.raises(ValueError):              # moves on another device
        rs.permute_rounds(buf, moves)


@pytest.mark.parametrize("kernel", ["flash_attention", "ssd_scan"])
def test_kernels_refuse_grad_off_the_cpu(kernel):
    """The hand-written kernels have no backward: an input off the CPU that
    requires grad raises while grad is enabled, before the device dispatch
    (``meta`` stands in for the card); on the CPU the plain versions
    differentiate."""
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ssd_scan as K

    def args(device, grad):
        if kernel == "flash_attention":
            shapes = ((1, 4, 8, 16), (1, 2, 8, 16), (1, 2, 8, 16))
        else:
            shapes = ((1, 8, 2, 16), (1, 8, 2), (2,), (1, 8, 2, 4),
                      (1, 8, 2, 4))
        g = torch.Generator().manual_seed(0)
        out = [torch.randn(s, generator=g).to(device) for s in shapes]
        if kernel == "ssd_scan":
            out[2] = -out[2].abs()
        out[1].requires_grad_(grad)
        return out

    fn = FA.flash_attention if kernel == "flash_attention" else K.ssd_scan
    with pytest.raises(RuntimeError, match="no backward"):
        fn(*args("meta", True))
    with torch.no_grad():                        # no grad: the usual refusal
        with pytest.raises(ValueError, match="cuda or cpu"):
            fn(*args("meta", True))
    cpu = args("cpu", True)
    fn(*cpu).sum().backward()
    assert cpu[1].grad is not None and torch.isfinite(cpu[1].grad).all()


def test_device_config_validation():
    from repro_torch.core.simconfig import DeviceConfig, SimConfig

    assert DeviceConfig(device="cpu", dtype="bfloat16").device == "cpu"
    with pytest.raises(ValueError):
        DeviceConfig(dtype="float64")
    with pytest.raises(ValueError):
        DeviceConfig(device="tpu")
    with pytest.raises(TypeError):
        SimConfig(device={"device": "cpu"})
    for gone in ("use_pallas", "interpret", "emulate", "mesh_shape", "axis"):
        assert not hasattr(DeviceConfig(), gone), gone


def test_kernel_engine_is_the_ports_kernelsim(monkeypatch):
    """``make_engine(engine="kernel")`` returns the port's ``KernelSim``,
    on cuda by default: building it needs no GPU, running its core on a
    host without one raises."""
    from repro_torch.core import kernelsim
    from repro_torch.core import topology as T
    from repro_torch.core.baselines import lower_baseline
    from repro_torch.core.intersection import ConflictModel
    from repro_torch.core.simulator import make_engine

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("REPRO_KERNEL_JIT", raising=False)
    topo = T.ring(4)
    cm = ConflictModel(topo)
    sim = make_engine(topo, cm, 0, engine="kernel")
    assert type(sim) is kernelsim.KernelSim and sim.device == "cuda"
    with pytest.raises(RuntimeError, match="cuda"):
        sim.run_lowered(lower_baseline(topo, cm, "binomial", 0, 4096))


def test_plan_server_and_store_serve_plans(tmp_path):
    """``compile(server=True)`` and ``compile(store=PlanStore(dir))`` attach
    a ``PlanServer`` that serves ``plan(root)``; the store keeps the
    canonical build on disk."""
    from repro_torch import api
    from repro_torch.core import topology as T
    from repro_torch.core.planstore import PlanStore

    for kw in (dict(server=True), dict(store=PlanStore(str(tmp_path)))):
        model = api.compile(T.ring(8), **kw)
        assert model.plan(3).root == 3 and model.plan(0).root == 0
        assert model.server.stats.builds == 1
        assert model.server.stats.requests == 2
    assert any(f.endswith(".pkl") for f in os.listdir(tmp_path))


def test_schedule_rejects_send_recv_on_one_row():
    """The in-place round step needs disjoint send and receive rows per
    device and sub-round; both the compiler and the importer check it."""
    from repro_torch.device.carry import import_schedule
    from repro_torch.device.schedule import NotDeviceExecutable, _NOSEND

    big = np.full((1, 3), _NOSEND, dtype=np.int64)
    neg = np.full((1, 3), -1, dtype=np.int64)
    fields = dict(num_devices=3, K=1, d=1, max_arrival=1, num_relay=1,
                  root=0, perms=[[(0, 1), (1, 2)]],
                  send_rel=big.copy(), recv_rel=big.copy(),
                  send_abs=neg.copy(), recv_abs=neg.copy())
    fields["send_rel"][0, 0] = 0
    fields["send_abs"][0, 1] = 0
    fields["recv_abs"][0, 1] = 1          # relay: reads slot 0, writes 1
    fields["recv_rel"][0, 2] = 0
    assert import_schedule(fields).d == 1
    fields["recv_abs"][0, 1] = 0          # reads and writes relay slot 0
    with pytest.raises(NotDeviceExecutable):
        import_schedule(fields)
    fields["recv_abs"][0, 1] = -1
    fields["send_abs"][0, 1] = -1
    fields["send_rel"][0, 1] = 0
    fields["recv_rel"][0, 1] = 0          # sends and receives packet rel 0
    with pytest.raises(NotDeviceExecutable):
        import_schedule(fields)


def test_import_schedule_checks_shapes():
    from repro_torch.device.carry import import_schedule

    t = np.zeros((2, 3), dtype=np.int64)
    with pytest.raises(ValueError):
        import_schedule(dict(num_devices=3, K=1, d=1, max_arrival=0,
                             num_relay=0, root=0, perms=[[]],
                             send_rel=t, recv_rel=t, send_abs=t,
                             recv_abs=t))
