"""Gradient compression (``repro_torch.runtime.compression``) against the
reference's (``repro.runtime.compression``).

- ``quantize_int8``, ``dequantize_int8``, ``init_residual`` and 64 steps
  of ``ef_compress_grads`` with the residual carried: bit-equal to the
  reference on the same numpy inputs (float32 and bfloat16 gradients).
- ``psum_compressed`` on four gloo ranks (one spawn): the int32 payload
  sums exactly; over a two-rank subgroup the result equals the
  reference's arithmetic (``jax.vmap`` of its ``psum_compressed`` over the
  ranks' inputs) bit for bit, and over all four within one float32 ulp
  (the scales' sum may associate differently). Against an exact float32
  all-reduce (the mean of the gradients): within the quantization bound,
  half the shared scale, when every worker's scale is the same; when the
  scales differ (worker r's gradient times r + 1) the error is pinned:
  it exceeds that bound, and equals what the reference's arithmetic
  gives (ROADMAP reference fault 10). The reference's
  ``test_compressed_dp_training_matches`` tolerance (0.05) is not a target
  here.
"""

import multiprocessing as mp
import os
import time

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.runtime import compression as R
from repro_torch.runtime import compression as C

WORLD = 4
TIMEOUT_S = 120
SHAPES = {"w": (64, 48), "b": (48,), "e": (3, 16, 8)}


def _grads(seed, dtype=np.float32, scale=1.0):
    rng = np.random.default_rng(seed)
    return {k: (rng.standard_normal(s) * scale).astype(dtype)
            for k, s in SHAPES.items()}


def _torch(a):
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(t):
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.uint16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


@pytest.mark.parametrize("dtype", [np.float32, ml_dtypes.bfloat16])
def test_quantize_and_dequantize_bit_equal(dtype):
    for seed in range(4):
        for g in _grads(seed, dtype, scale=10.0 ** (seed - 2)).values():
            q, s = C.quantize_int8(_torch(g))
            rq, rs = R.quantize_int8(jnp.asarray(g))
            np.testing.assert_array_equal(_np(q), np.asarray(rq))
            np.testing.assert_array_equal(_np(s), np.asarray(rs))
            np.testing.assert_array_equal(
                _np(C.dequantize_int8(q, s)),
                np.asarray(R.dequantize_int8(rq, rs)))


@pytest.mark.parametrize("dtype", [np.float32, ml_dtypes.bfloat16])
def test_error_feedback_over_64_steps_bit_equal(dtype):
    params = _grads(0, dtype)
    res = C.init_residual({k: _torch(v) for k, v in params.items()})
    rres = R.init_residual({k: jnp.asarray(v) for k, v in params.items()})
    for k in SHAPES:
        assert res[k].dtype == torch.float32
        np.testing.assert_array_equal(_np(res[k]), np.asarray(rres[k]))
    for step in range(64):
        g = _grads(100 + step, dtype)
        q, s, res = C.ef_compress_grads({k: _torch(v) for k, v in g.items()},
                                        res)
        rq, rs, rres = R.ef_compress_grads(
            {k: jnp.asarray(v) for k, v in g.items()}, rres)
        for k in SHAPES:
            np.testing.assert_array_equal(_np(q[k]), np.asarray(rq[k]))
            np.testing.assert_array_equal(_np(s[k]), np.asarray(rs[k]))
            np.testing.assert_array_equal(_np(res[k]), np.asarray(rres[k]))


# ------------------------------------------------------ four gloo ranks

CASES = {"same": lambda r: _same_scale(r),
         "apart": lambda r: _grads(7 + r, scale=r + 1.0)}


def _same_scale(rank):
    """Worker ``rank``'s gradients with one max |g| on every worker, so
    that the scales agree."""
    g = _grads(7 + rank)
    for k, v in g.items():
        i = np.unravel_index(np.argmax(np.abs(v)), v.shape)
        v[i] = 8.0
    return g


def _worker(rank, store_path, out_dir):
    import torch.distributed as dist

    dist.init_process_group("gloo", store=dist.FileStore(store_path, WORLD),
                            rank=rank, world_size=WORLD)
    try:
        pair = dist.new_group([0, 1])
        out = {}
        for case, make in CASES.items():
            g = {k: torch.from_numpy(v) for k, v in make(rank).items()}
            q, s, _ = C.ef_compress_grads(g, C.init_residual(g))
            got = C.psum_compressed(q, s)
            summed = {k: v.to(torch.int32) for k, v in q.items()}
            for v in summed.values():
                dist.all_reduce(v)
            for k in SHAPES:
                out[f"{case}/all/{k}"] = got[k].numpy()
                out[f"{case}/int/{k}"] = summed[k].numpy()
            if rank < 2:
                got = C.psum_compressed(q, s, group=pair)
                for k in SHAPES:
                    out[f"{case}/pair/{k}"] = got[k].numpy()
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("psum")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_worker, args=(r, str(tmp / "store"),
                                               str(tmp)))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + TIMEOUT_S
    try:
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        alive = [p.pid for p in procs if p.is_alive()]
        assert not alive, f"ranks {alive} still running after {TIMEOUT_S} s"
        assert [p.exitcode for p in procs] == [0] * WORLD
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
    return [dict(np.load(tmp / f"rank{r}.npz")) for r in range(WORLD)]


def _reference(case, n):
    """The reference's ``psum_compressed`` over ``n`` workers (``jax.vmap``
    with a named axis), on their ``ef_compress_grads`` payloads."""
    qs, ss = [], []
    for r in range(n):
        g = {k: jnp.asarray(v) for k, v in CASES[case](r).items()}
        q, s, _ = R.ef_compress_grads(g, R.init_residual(g))
        qs.append(q)
        ss.append(s)
    stack = jax.tree.map(lambda *a: jnp.stack(a), *qs)
    sstack = jax.tree.map(lambda *a: jnp.stack(a), *ss)
    out = jax.vmap(lambda q, s: R.psum_compressed(q, s, "i"),
                   axis_name="i")(stack, sstack)
    return {k: np.asarray(v[0]) for k, v in out.items()}, qs, ss


@pytest.mark.parametrize("case", list(CASES))
def test_psum_compressed_is_the_reference_arithmetic(ranks, case):
    for n, group in ((2, "pair"), (WORLD, "all")):
        want, qs, _ = _reference(case, n)
        for r in range(n):
            for k in SHAPES:
                got = ranks[r][f"{case}/{group}/{k}"]
                if n == 2:
                    np.testing.assert_array_equal(got, want[k])
                else:
                    np.testing.assert_array_max_ulp(got, want[k], maxulp=1)
    ints = {k: sum(np.asarray(q[k]).astype(np.int32) for q in qs)
            for k in SHAPES}
    for r in range(WORLD):
        for k in SHAPES:
            np.testing.assert_array_equal(ranks[r][f"{case}/int/{k}"],
                                          ints[k])


def test_psum_compressed_error_against_an_exact_all_reduce(ranks):
    errs = {}
    for case in CASES:
        _, _, scales = _reference(case, WORLD)
        for k in SHAPES:
            exact = np.mean([CASES[case](r)[k] for r in range(WORLD)],
                            axis=0, dtype=np.float32)
            got = ranks[0][f"{case}/all/{k}"]
            s = [float(x[k]) for x in scales]
            bound = max(s) / 2 * (1 + 1e-5)
            errs[(case, k)] = (float(np.abs(got - exact).max()), bound)
            if case == "same":
                assert max(s) == min(s)
                assert errs[(case, k)][0] <= bound, (k, errs[(case, k)])
    # scales apart: the mean scale times the summed integers is no longer
    # the mean of the dequantized gradients (reference fault 10)
    assert all(errs[("apart", k)][0] > errs[("apart", k)][1]
               for k in SHAPES), errs
