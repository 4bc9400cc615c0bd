"""Build the port's hand-written CUDA kernels and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
for Hopper (``sm_90a``) into a shared library, at first use, from the
sources in the package. The library is keyed by a hash of its source, the
shared headers (``csrc/*.cuh``) and the flags, so an edited source or
header is rebuilt and an unchanged one is loaded as it is. The build directory (``_build/`` beside this file) is listed in
``.gitignore``. ``build`` compiles several sources at once, one ``nvcc``
process each, all started together.

Nothing here runs at import time: the CPU tests import every module of the
port, and ``nvcc`` is only touched when a kernel is first launched on a
CUDA tensor (or ``build`` is called).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Sequence, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# flags of one source on top of NVCC_FLAGS: the event core's float64 adds
# must round as numpy's do, so no contraction into fused multiply-adds
EXTRA_FLAGS: Dict[str, Sequence[str]] = {"event_core": ("-fmad=false",)}

_libs: Dict[Tuple[str, Tuple[str, ...]], ctypes.CDLL] = {}
_lock = threading.Lock()


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on the
    ``PATH``, else ``/usr/local/cuda/bin/nvcc``; raises if there is none."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    cands += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the port's CUDA kernels are built from source")


def _flags(name: str, defines: Sequence[str]) -> Tuple[str, ...]:
    return (*NVCC_FLAGS, *EXTRA_FLAGS.get(name, ()),
            *(f"-D{d}" for d in defines))


def _lib_path(name: str, defines: Sequence[str] = ()) -> Path:
    # the source, the headers it may include and the flags
    src = (CSRC / f"{name}.cu").read_bytes() + b"".join(
        h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    flags = " ".join(_flags(name, defines))
    key = hashlib.sha256(src + flags.encode()).hexdigest()
    return BUILD_DIR / f"lib{name}_{key[:16]}.so"


def build(names: Sequence[str], defines: Sequence[str] = ()
          ) -> Dict[str, Path]:
    """Compile every named source that has no up-to-date library yet, all
    ``nvcc`` processes started together, with ``-D`` for each of
    ``defines``; returns the library paths. The compiler's report
    (``-Xptxas -v``: registers, spills) is kept beside each library as
    ``.log``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {name: _lib_path(name, defines) for name in names}
    todo = {name: p for name, p in paths.items() if not p.exists()}
    if not todo:
        return paths
    nvcc = nvcc_path()
    procs = {}
    for name, p in todo.items():
        tmp = p.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *_flags(name, defines), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, p)
    failed = []
    for name, (proc, tmp, p) in procs.items():
        out, _ = proc.communicate()
        p.with_suffix(".log").write_text(out)
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exit {proc.returncode}\n{out}")
            continue
        os.replace(tmp, p)        # atomic: a concurrent loader sees all or none
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return paths


def load(name: str, defines: Sequence[str] = ()) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` built with ``defines``,
    built first if needed."""
    key = (name, tuple(defines))
    with _lock:
        lib = _libs.get(key)
        if lib is None:
            lib = _libs[key] = ctypes.CDLL(
                str(build([name], defines)[name]))
        return lib


def build_log(name: str) -> str:
    """The compiler's report for the current build of ``name``."""
    return _lib_path(name).with_suffix(".log").read_text()
