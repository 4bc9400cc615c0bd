"""The whole slice against the reference: byte-identical broadcasts.

One subprocess runs the reference's ``api.compile(topo).executable(...)
.run`` on an 8-device XLA-emulated host mesh (as tests/test_device.py does)
for every case below, plus its ``binomial_broadcast`` and
``chain_broadcast``, and writes the raw bytes of every output, the input
and the reference's schedule tables to ``tmp_path``. In-process, the port
computes the same cases on the CPU in two ways -- through its own plans,
and through ``import_schedule`` of the reference's tables -- and every
output must be byte-identical. Tolerance: exact.
"""

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

FABRICS = ("ring8", "hypercube3")
CASES = ([(f, "bbs", nb, root, dt) for f in FABRICS
          for nb in (4 << 10, 64 << 10) for root in (0, 3)
          for dt in ("float32", "bfloat16")]
         + [(f, algo, 4 << 10, root, dt) for f in FABRICS
            for algo in ("bine_tree", "binomial") for root in (0, 3)
            for dt in ("float32", "bfloat16")])

REFERENCE = """
import dataclasses, json, sys
import numpy as np, jax.numpy as jnp
from jax.sharding import Mesh
import jax
from repro import api
from repro.core import topology as T
from repro.device import binomial_broadcast, chain_broadcast

out_dir = sys.argv[1]
cases = json.load(open(out_dir + "/cases.json"))
fabrics = {"ring8": lambda: T.ring(8), "hypercube3": lambda: T.hypercube(3)}
models = {}
arrays, meta = {}, []
for i, (fab, algo, nbytes, root, dt) in enumerate(cases):
    model = models.setdefault(fab, api.compile(fabrics[fab]()))
    f = np.random.RandomState(i).standard_normal(nbytes // 4)
    x = jnp.asarray(f.astype(np.float32)).astype(getattr(jnp, dt))
    ex = model.executable(root=root, nbytes=nbytes, algo=algo)
    arrays[f"in{i}"] = np.asarray(x).view(np.uint8)
    out = ex.run(jnp.asarray(np.asarray(x)))
    arrays[f"out{i}"] = np.asarray(out).view(np.uint8)
    fields = dataclasses.asdict(ex.schedule)
    for k, v in fields.items():
        if isinstance(v, np.ndarray):
            fields[k] = v.tolist()
    meta.append({"candidate": ex.candidate, "num_groups": ex.num_groups,
                 "schedule": fields})
mesh = Mesh(np.array(jax.devices()), ("x",))
x = jnp.linspace(-1, 1, 513, dtype=jnp.float32)
arrays["bin_in"] = np.asarray(x).view(np.uint8)
arrays["bin_out"] = np.asarray(binomial_broadcast(x, mesh, "x", root=5)
                               ).view(np.uint8)
arrays["chain_out"] = np.asarray(chain_broadcast(x, mesh, "x", root=5,
                                                 num_packets=7)).view(np.uint8)
np.savez(out_dir + "/ref.npz", **arrays)
json.dump(meta, open(out_dir + "/meta.json", "w"))
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    out = tmp_path_factory.mktemp("reference")
    (out / "cases.json").write_text(json.dumps(CASES))
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    proc = subprocess.run([sys.executable, "-c", textwrap.dedent(REFERENCE),
                           str(out)], capture_output=True, text=True,
                          env=env, timeout=900)
    assert proc.returncode == 0, f"stdout:\n{proc.stdout}\n" \
                                 f"stderr:\n{proc.stderr}"
    return (dict(np.load(out / "ref.npz")),
            json.loads((out / "meta.json").read_text()))


def _tensor(raw, dtype):
    return torch.from_numpy(raw.copy()).view(getattr(torch, dtype))


def _bytes(t):
    return t.contiguous().view(torch.uint8).numpy()


def test_slice_outputs_byte_identical_to_reference(reference):
    from repro_torch import api
    from repro_torch.core import topology as T
    from repro_torch.core.simconfig import DeviceConfig, SimConfig
    from repro_torch.device import LoweredPlan, broadcast, import_schedule

    arrays, meta = reference
    cpu = SimConfig(device=DeviceConfig(device="cpu"))
    models = {"ring8": api.compile(T.ring(8)),
              "hypercube3": api.compile(T.hypercube(3))}
    relay_seen = False
    for i, (fab, algo, nbytes, root, dt) in enumerate(CASES):
        x = _tensor(arrays[f"in{i}"], dt)
        want = arrays[f"out{i}"]
        assert want.shape[0] == 8
        ex = models[fab].executable(root=root, nbytes=nbytes, algo=algo,
                                    config=cpu)
        assert (ex.candidate, ex.num_groups) == \
            (meta[i]["candidate"], meta[i]["num_groups"]), (i, CASES[i])
        got = ex.run(x)
        assert got.shape == (8,) + tuple(x.shape)
        np.testing.assert_array_equal(_bytes(got).reshape(want.shape), want,
                                      err_msg=f"own plan, case {CASES[i]}")
        sched = import_schedule(meta[i]["schedule"])
        relay_seen |= sched.num_relay > 0
        got = broadcast(LoweredPlan(sched, meta[i]["num_groups"], x, "cpu"), x)
        np.testing.assert_array_equal(_bytes(got).reshape(want.shape), want,
                                      err_msg=f"imported tables, {CASES[i]}")
        assert ex.verify(x).ok
    assert relay_seen, "no case exercised relay rows"


def test_baseline_runners_byte_identical_to_reference(reference):
    from repro_torch.device import binomial_broadcast, chain_broadcast

    arrays, _ = reference
    x = _tensor(arrays["bin_in"], "float32")
    got = binomial_broadcast(x, 8, root=5, device="cpu")
    np.testing.assert_array_equal(_bytes(got).reshape(8, -1),
                                  arrays["bin_out"].reshape(8, -1))
    got = chain_broadcast(x, 8, root=5, num_packets=7, device="cpu")
    np.testing.assert_array_equal(_bytes(got).reshape(8, -1),
                                  arrays["chain_out"].reshape(8, -1))
