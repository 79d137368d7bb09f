"""Build and load the port's CUDA kernels.

Each `csrc/<name>.cu` is compiled by `nvcc` into its own shared library with
a plain C interface and loaded with `ctypes`. The build happens at first
use, from the sources in the checkout only, into `kagnn_tpu_torch/_build/`
(listed in .gitignore). A library's file name carries a hash of its sources
and flags, so an edited source is rebuilt. `build_all` starts one `nvcc`
per source at once and waits for all of them.

A failed build raises; nothing here falls back to another path.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD = PKG / "_build"
SOURCES = ("spmm", "bspline_fused", "gin_fused", "gcn_agg", "fastkan_layer",
           "gin_fastkan", "gat_fused", "gat_bwd", "rbf_fused", "spmm_narrow")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}
_PTXAS: dict[str, str] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels of kagnn_tpu_torch "
                       "are built at first use and need the CUDA toolkit")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(f.read_bytes())
    return BUILD / f"{name}-{h.hexdigest()[:16]}.so"


def _start(name: str):
    out = _lib_path(name)
    if out.exists():
        return None
    BUILD.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out, cmd


def _finish(name: str, started) -> str | None:
    """Wait for one nvcc; install its library. Returns an error message
    when it failed."""
    if started is None:
        return None
    proc, tmp, out, cmd = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        return (f"nvcc failed for {name} (exit {proc.returncode}):"
                f"\n{' '.join(cmd)}\n{log}")
    os.replace(tmp, out)
    _PTXAS[name] = log
    return None


def build_all(names=SOURCES) -> dict[str, str]:
    """Compile every kernel source not yet built, one `nvcc` each, all
    started together, and wait for all of them before raising on a failed
    one. Returns the compiler's resource report per source built now
    (registers, shared memory, spills)."""
    with _LOCK:
        started = {n: _start(n) for n in names}
        errors = [e for e in (_finish(n, s) for n, s in started.items()) if e]
    if errors:
        raise RuntimeError("\n\n".join(errors))
    return {n: _PTXAS[n] for n in names if n in _PTXAS}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build_all((name,))
        lib = ctypes.CDLL(str(_lib_path(name)))
        _LIBS[name] = lib
    return lib


P = ctypes.c_void_p
I = ctypes.c_int
F = ctypes.c_float


def bind(name: str, fn: str, argtypes) -> ctypes._CFuncPtr:
    f = getattr(load(name), fn)
    f.argtypes = list(argtypes)
    f.restype = ctypes.c_int
    return f


def check(err: int, what: str) -> None:
    """Raise on a CUDA error code returned by a launcher."""
    if err != 0:
        raise RuntimeError(f"CUDA launch of {what} failed with "
                           f"cudaError {err}")
