"""Run a function on N ranks of a `torch.distributed` process group, one
process each (torch.multiprocessing, spawn): the port's counterpart of the
JAX package's one-process mesh over several devices.

    results = launch(fn, 4, (arg,), backend="gloo", device="cpu")

calls fn(rank, world_size, arg) in each rank after `init_process_group`
(a FileStore, so that no TCP port is taken) and returns the ranks' return
values, in rank order (each must be picklable by torch.save). The backend is
the caller's: "nccl" for one card a rank (rank r on cuda:r; asking for more
ranks than there are cards raises), "gloo" for the CPU and for several
ranks that share one card (every rank on the current card). Nothing falls
back to another backend.

The parent joins every rank within `timeout` seconds and raises if one
fails, exits non-zero or is still running then (the rest are ended). The
workers import only torch and this package. On the card the parent builds
the main paths' CUDA libraries (`kernels/_build.MAIN`) before it spawns,
so that the ranks load them instead of racing nvcc; a library of another
shape is built by the first rank that needs it, under the file lock that
kernels/_build.py takes while it builds.
"""
from __future__ import annotations

import os
import shutil
import tempfile
import time
from pathlib import Path

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

BACKENDS = ("gloo", "nccl")


def check_backend(backend: str, nprocs: int, device: str) -> None:
    """Raise unless `backend` can run `nprocs` ranks on `device`."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    dev = torch.device(device)
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("the nccl backend runs on CUDA devices; use gloo on "
                         "the CPU")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("ranks on CUDA were asked for and no CUDA device is "
                           "available")
    if backend == "nccl" and nprocs > torch.cuda.device_count():
        raise RuntimeError(
            f"nccl takes one card a rank: {nprocs} ranks were asked for and "
            f"this host has {torch.cuda.device_count()} card(s); run several "
            f"ranks on one card with backend='gloo'")


def _worker(rank, fn, nprocs, backend, device, store_path, out_dir, threads, args):
    if threads is not None:
        torch.set_num_threads(threads)
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(rank if backend == "nccl" else
                              torch.device(device).index or 0)
    store = dist.FileStore(store_path, nprocs)
    dist.init_process_group(backend, store=store, rank=rank, world_size=nprocs)
    try:
        result = fn(rank, nprocs, *args)
        torch.save(result, Path(out_dir) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def launch(fn, nprocs: int, args=(), *, backend: str, device: str = "cuda",
           timeout: float = 900.0, threads=None, store_path=None) -> list:
    """fn(rank, nprocs, *args) on `nprocs` ranks; returns their results.
    `fn` must be importable by name (a module-level function). `threads`
    sets torch's intra-op threads in each rank; `store_path` names the
    FileStore's file (a fresh temporary one by default; it must not
    exist)."""
    check_backend(backend, nprocs, device)
    if torch.device(device).type == "cuda":
        from kagnn_tpu_torch.kernels import _build

        _build.build_all(_build.MAIN)
    out_dir = tempfile.mkdtemp(prefix="kagnn_launch_")
    try:
        store = str(store_path) if store_path is not None else os.path.join(out_dir, "store")
        ctx = mp.start_processes(
            _worker, args=(fn, nprocs, backend, device, store, out_dir, threads,
                           tuple(args)),
            nprocs=nprocs, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout
        try:
            while not ctx.join(timeout=max(0.0, deadline - time.monotonic())):
                if time.monotonic() >= deadline:
                    raise TimeoutError(f"{nprocs} ranks of {getattr(fn, '__name__', fn)} "
                                       f"did not finish within {timeout} s")
        except BaseException:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
            for p in ctx.processes:
                p.join(10)
            raise
        bad = [p.exitcode for p in ctx.processes if p.exitcode != 0]
        if bad:
            raise RuntimeError(f"ranks exited with codes {bad}")
        return [torch.load(Path(out_dir) / f"rank{r}.pt", weights_only=False)
                for r in range(nprocs)]
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
