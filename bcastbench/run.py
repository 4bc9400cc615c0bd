"""Run one cell of ``BENCHMARK.json`` once, from the root of a checkout::

    python3 bcastbench/run.py --workload <name> --seed <n> \
        --seconds <run_seconds> --trace <0|1>

Stdout ends with the result line (``bcastbench.harness``); stderr's
earlier lines split the set-up, give the plan store's size, what K1 ran
against what the plans ask and how many copies were compared, and its last
lines the numbers compared with their limits. With ``--trace 1`` the line
carries the cell's per-layer metrics, the device's busy seconds and the
traced window, and a ``breakdown``; without, its end-to-end metrics.

It runs on NVIDIA GPUs only: without CUDA, or with fewer cards than the
cell asks for, it exits with 2 and prints no result. Every cache it or the
program writes lies inside the checkout: the program's kernels in
``src/repro_torch/_build/``, the plans in ``bcastbench/.cache/plans/``.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
for _var, _sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("TRITON_CACHE_DIR", "triton"),
                   ("CUDA_CACHE_PATH", "cuda")):
    os.environ[_var] = str(HERE / ".cache" / _sub)
sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != HERE]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from bcastbench import harness, manifest
    from bcastbench.drive import drive

    cell = manifest.find_cell(args.workload, root=ROOT)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        harness.log(f"[device] {cell.name} needs {cell.chips} CUDA "
                    f"device(s); torch.cuda.is_available() "
                    f"{torch.cuda.is_available()}, device_count() "
                    f"{torch.cuda.device_count()}; no result")
        return 2
    result, checks = drive(cell, args.seed, args.seconds, bool(args.trace),
                           T_START)
    return harness.finish(result, checks)


if __name__ == "__main__":
    sys.exit(main())
