"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

``csrc/<name>.cu`` becomes one shared library with a plain C interface,
compiled for ``sm_90a`` at first use into ``ops/build/`` (listed in
``.gitignore``), named by a hash of its source so an edited kernel is
rebuilt; :func:`build` starts one ``nvcc`` per source, all together.
Nothing here runs at import time: the CPU tests import every
module of the port on a machine without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# name -> {"seconds": build wall time, "log": nvcc's output (ptxas -v)}
build_info: dict[str, dict] = {}
_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    cands = [str(Path(home) / "bin" / "nvcc")] if home else []
    cands += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit "
                       "(set CUDA_HOME or put nvcc on PATH)")


def _target(name: str) -> tuple[Path, Path]:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    return src, BUILD_DIR / f"lib{name}_{digest}.so"


def build(names) -> None:
    """Compile ``csrc/<name>.cu`` for every name not built yet, one ``nvcc``
    process per source, all started together; raises with nvcc's output if
    any compile fails."""
    jobs = []
    for name in names:
        src, out = _target(name)
        if out.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs.append((name, src, out, tmp, proc, time.perf_counter()))
    failed = []
    for name, src, out, tmp, proc, t0 in jobs:
        log, _ = proc.communicate()
        build_info[name] = {"seconds": time.perf_counter() - t0, "log": log}
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"kernel build of {src.name} failed: nvcc exit {proc.returncode}\n{log}")
        else:
            os.replace(tmp, out)  # atomic: a concurrent process never loads half a file
    if failed:
        raise RuntimeError("\n".join(failed))


def load(name: str, signatures: dict) -> ctypes.CDLL:
    """The library of ``csrc/<name>.cu``, with ``argtypes`` and an int
    ``restype`` (a cudaError_t) set from ``signatures``."""
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(_target(name)[1]))
        for fn, argtypes in signatures.items():
            f = getattr(lib, fn)
            f.argtypes = argtypes
            f.restype = ctypes.c_int
        _loaded[name] = lib
    return lib
