"""Build and load the port's CUDA kernels.

Each `csrc/<name>.cu` is compiled by `nvcc` into its own shared library with
a plain C interface and loaded with `ctypes`. The build happens at first
use, from the sources in the checkout only, into `kagnn_tpu_torch/_build/`
(listed in .gitignore). A library's file name carries a hash of its sources
and flags, so an edited source is rebuilt. `build_all` starts one `nvcc`
per library at once and waits for all of them.

The layer kernels are templates over their shape: the spline order and grid
size of the B-spline sources (`KAN_ORDER`, `KAN_GRID`), the number of RBF
centers of the FastKAN sources (`FKAN_G`). Each shape a caller asks for is
its own library, built at its first use with the shape as `-D` defines
(`SHAPED`), so a build compiles one instantiation and no list of shapes is
fixed in advance. `MAIN` names the libraries of the main paths.

Several processes may build at once (the ranks of dist/launch.py, whose
parent builds first): `build_all` holds a file lock on `_build/.lock`
while it compiles, so a library is built once and the others load it.

A failed build raises; nothing here falls back to another path.
"""
from __future__ import annotations

import ctypes
import fcntl
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
           "gin_fastkan", "gat_fused", "gat_bwd", "rbf_fused", "spmm_narrow",
           "masked_bn")
# the sources built per shape, with the names of their shape's defines
SHAPED = {"bspline_fused": ("KAN_ORDER", "KAN_GRID"),
          "gin_fused": ("KAN_ORDER", "KAN_GRID"),
          "fastkan_layer": ("FKAN_G",), "gin_fastkan": ("FKAN_G",),
          "rbf_fused": ("FKAN_G",)}
# (source, shape) of the main paths' libraries: spline order 3, grid 4; 4
# centers; the base-free FastKAN's RBF product at 8
MAIN = (("spmm", ()), ("bspline_fused", (3, 4)), ("gin_fused", (3, 4)),
        ("gcn_agg", ()), ("fastkan_layer", (4,)), ("gin_fastkan", (4,)),
        ("gat_fused", ()), ("gat_bwd", ()), ("rbf_fused", (8,)),
        ("spmm_narrow", ()), ("masked_bn", ()))
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LOCK = threading.Lock()
_LIBS: dict[tuple, ctypes.CDLL] = {}
_PTXAS: dict[str, str] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels of kagnn_tpu_torch "
                       "are built at first use and need the CUDA toolkit")


def _defines(name: str, shape: tuple) -> list[str]:
    keys = SHAPED.get(name, ())
    if len(keys) != len(shape):
        raise ValueError(f"{name} is built for a shape of {len(keys)} values "
                         f"{keys}, got {shape}")
    return [f"-D{k}={int(v)}" for k, v in zip(keys, shape)]


def label(name: str, shape: tuple = ()) -> str:
    """The library's name: the source, then its shape (bspline_fused-3x4)."""
    return "-".join([name] + (["x".join(str(int(v)) for v in shape)] if shape else []))


def _lib_path(name: str, shape: tuple = ()) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS + _defines(name, shape)).encode())
    for f in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(f.read_bytes())
    return BUILD / f"{label(name, shape)}-{h.hexdigest()[:16]}.so"


def _start(name: str, shape: tuple):
    out = _lib_path(name, shape)
    if out.exists():
        return None
    BUILD.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, *_defines(name, shape), "-o", str(tmp),
           str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out, cmd


def _finish(lab: str, started) -> str | None:
    """Wait for one nvcc; install its library. Returns an error message
    when it failed."""
    if started is None:
        return None
    proc, tmp, out, cmd = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        return (f"nvcc failed for {lab} (exit {proc.returncode}):"
                f"\n{' '.join(cmd)}\n{log}")
    os.replace(tmp, out)
    _PTXAS[lab] = log
    return None


def build_all(units=MAIN) -> dict[str, str]:
    """Compile every library of `units` ((source, shape) pairs) not yet
    built, one `nvcc` each, all started together, and wait for all of them
    before raising on a failed one. Returns the compiler's resource report
    per library built now (registers, shared memory, spills), by `label`."""
    units = [(n, tuple(s)) for n, s in units]
    with _LOCK:
        if all(_lib_path(n, s).exists() for n, s in units):
            return {}
        BUILD.mkdir(parents=True, exist_ok=True)
        with open(BUILD / ".lock", "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            started = {label(n, s): _start(n, s) for n, s in units}
            errors = [e for e in (_finish(k, v) for k, v in started.items()) if e]
    if errors:
        raise RuntimeError("\n\n".join(errors))
    return {k: _PTXAS[k] for k in started if k in _PTXAS}


def load(name: str, shape: tuple = ()) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu` at `shape`, built first if
    needed."""
    key = (name, tuple(int(v) for v in shape))
    lib = _LIBS.get(key)
    if lib is None:
        build_all((key,))
        lib = ctypes.CDLL(str(_lib_path(*key)))
        _LIBS[key] = lib
    return lib


P = ctypes.c_void_p
I = ctypes.c_int
F = ctypes.c_float


def bind(name: str, fn: str, argtypes, shape: tuple = ()) -> ctypes._CFuncPtr:
    f = getattr(load(name, shape), fn)
    f.argtypes = list(argtypes)
    f.restype = ctypes.c_int
    return f


def check(err: int, what: str) -> None:
    """Raise on a CUDA error code returned by a launcher."""
    if err != 0:
        raise RuntimeError(f"CUDA launch of {what} failed with "
                           f"cudaError {err}")
