"""Profiling and roofline reporting on the card, the port of
`kagnn_tpu/utils/profiling.py`:

  * `trace(logdir)` — a torch.profiler trace of the host and the card,
    written as a Chrome trace (`logdir/trace.json`, for Perfetto);
  * `HardwarePeaks`, `H100` — published peaks, and `bound_ms`, the least
    time a card could take for some bytes and operations;
  * `Roofline` — analytic FLOP/byte model against the peaks, reporting
    compute and bandwidth utilization and the bound resource;
  * `time_ms(fn)` — a function's time on the card from CUDA events;
  * `kernel_report(...)` — the fused KAN kernels and their eager torch paths
    at given shapes, one roofline row each;
  * `device_profile(run, n_calls)` — device kernel time per call, in all
    and by kernel, and the host operators' self time, from torch.profiler;
  * `kernel_row_of(key, launches)` — the kernel row (PERF.md §6) of a
    profiled CUDA kernel name.

Nothing here times the CPU: `time_ms` and `kernel_report` raise without a
CUDA device, where there is no kernel to time.
"""
from __future__ import annotations

import contextlib
import dataclasses
from pathlib import Path
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F

from kagnn_tpu_torch.utils.device import resolve_device


def _activities():
    from torch.profiler import ProfilerActivity

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return acts


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the body; write `logdir/trace.json`. Yields the profiler."""
    from torch.profiler import profile

    out = Path(logdir)
    out.mkdir(parents=True, exist_ok=True)
    with profile(activities=_activities()) as prof:
        yield prof
    prof.export_chrome_trace(str(out / "trace.json"))


@dataclasses.dataclass(frozen=True)
class HardwarePeaks:
    name: str
    flops_bf16: float  # FLOP/s
    flops_f32: float
    hbm_gbps: float  # bytes/s

    def bound_ms(self, nbytes: float, ops: float,
                 dtype: str = "bfloat16") -> tuple[float, str]:
        """(the larger of bytes over the memory rate and operations over the
        peak rate of `dtype` ("bfloat16" or "float32"), in ms; which of the
        two it is: "bytes" or "operations")."""
        t_bytes = nbytes / self.hbm_gbps
        t_ops = ops / (self.flops_bf16 if dtype == "bfloat16" else self.flops_f32)
        return (max(t_bytes, t_ops) * 1e3,
                "bytes" if t_bytes >= t_ops else "operations")


# NVIDIA H100 SXM (data sheet, dense): 989 TFLOP/s bf16 on the tensor cores,
# 67 TFLOP/s f32 outside them, 3.35 TB/s of HBM3, at the 700 W power limit.
H100 = HardwarePeaks("h100-sxm", 989e12, 67e12, 3.35e12)


@dataclasses.dataclass
class Roofline:
    label: str
    flops: float
    bytes_accessed: float
    seconds: float
    peaks: HardwarePeaks = H100
    dtype: str = "f32"

    @property
    def achieved_flops(self) -> float:
        return self.flops / self.seconds

    @property
    def achieved_gbps(self) -> float:
        return self.bytes_accessed / self.seconds

    @property
    def compute_util(self) -> float:
        peak = (self.peaks.flops_bf16 if self.dtype == "bf16"
                else self.peaks.flops_f32)
        return self.achieved_flops / peak

    @property
    def bandwidth_util(self) -> float:
        return self.achieved_gbps / self.peaks.hbm_gbps

    @property
    def bound(self) -> str:
        # the resource closer to its peak is the binding one
        return "compute" if self.compute_util >= self.bandwidth_util else "hbm"

    def row(self) -> dict:
        return {
            "kernel": self.label,
            "seconds": round(self.seconds, 6),
            "tflops": round(self.achieved_flops / 1e12, 2),
            "gbps": round(self.achieved_gbps / 1e9, 1),
            "compute_util": round(self.compute_util, 4),
            "bandwidth_util": round(self.bandwidth_util, 4),
            "bound": self.bound,
            "hw": self.peaks.name,
        }


def time_ms(fn: Callable[[], object], iters: int = 20, warmup: int = 3) -> float:
    """ms per call of fn() on the card: CUDA events around `iters` calls
    after `warmup` calls, then a synchronize."""
    if not torch.cuda.is_available():
        raise RuntimeError("time_ms times CUDA kernels and needs a CUDA device")
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def kernel_report(n: int = 131072, d: int = 64, o: int = 64,
                  grid_size: int = 4, spline_order: int = 3,
                  num_grids: int = 8, iters: int = 20,
                  peaks: HardwarePeaks = H100, device=None) -> list[dict]:
    """Roofline rows (f32) for the fused B-spline, RBF and FastKANLayer
    kernels and their eager torch paths at the given shapes, forward only.
    Raises on a CPU device."""
    from kagnn_tpu_torch.kan import bspline, rbf
    from kagnn_tpu_torch.kernels.bspline_fused import kan_linear_fused
    from kagnn_tpu_torch.kernels.fastkan_layer import fastkan_layer_fused
    from kagnn_tpu_torch.kernels.rbf_fused import fastkan_fused

    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError(f"kernel_report times the CUDA kernels; on {dev} "
                         f"there is no kernel to time")
    rng = np.random.default_rng(0)

    def normal(*shape, scale=1.0):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)
                                * scale).to(dev)

    x = normal(n, d)
    rows = []

    def add(label, fn, flops, nbytes):
        with torch.no_grad():
            sec = time_ms(fn, iters=iters) / 1e3
        rows.append(Roofline(label, flops, nbytes, sec, peaks).row())

    # ---- B-spline
    nb = grid_size + spline_order
    grid = bspline.make_grid(d, grid_size, spline_order, device=dev)
    wb = normal(o, d, scale=0.1)
    ws = normal(o, d, nb, scale=0.1)
    flops_bs = 2 * n * d * o * (nb + 1)
    bytes_fused = 4 * (n * d + n * o + d * o * (nb + 1))
    add("bspline_fused", lambda: kan_linear_fused(x, grid, wb, ws, spline_order),
        flops_bs, bytes_fused)

    def bs_eager():
        base = F.silu(x) @ wb.T
        bases = bspline.b_splines(x, grid, spline_order)
        return base + bases.reshape(n, -1) @ ws.reshape(o, -1).T

    add("bspline_eager", bs_eager, flops_bs,
        bytes_fused + 2 * 4 * n * d * nb)  # the basis round-trips HBM

    # ---- RBF
    w = normal(o, d * num_grids, scale=0.1)
    h = 4.0 / (num_grids - 1)
    centers = rbf.make_rbf_grid(-2.0, 2.0, num_grids, device=dev)
    flops_rbf = 2 * n * d * o * num_grids
    bytes_rbf_fused = 4 * (n * d + n * o + d * o * num_grids)
    add("rbf_fused", lambda: fastkan_fused(x, w, -2.0, 2.0, num_grids),
        flops_rbf, bytes_rbf_fused)
    add("rbf_eager", lambda: rbf.rbf_basis(x, centers, h).reshape(n, -1) @ w.T,
        flops_rbf, bytes_rbf_fused + 2 * 4 * n * d * num_grids)

    # ---- full FastKAN layer (layernorm + RBF + spline GEMM + base GEMM)
    lng = torch.ones(d, device=dev)
    lnb = torch.zeros(d, device=dev)
    wbase = normal(o, d, scale=0.1)
    bbase = torch.zeros(o, device=dev)
    flops_layer = flops_rbf + 2 * n * d * o + 10 * n * d
    bytes_layer_fused = 4 * (n * d + n * o + d * o * (num_grids + 1))
    add("fastkan_layer_fused",
        lambda: fastkan_layer_fused(x, lng, lnb, w, wbase, bbase, -2.0, 2.0,
                                    num_grids),
        flops_layer, bytes_layer_fused)

    def layer_eager():
        mu = x.mean(1, keepdim=True)
        var = ((x - mu) ** 2).mean(1, keepdim=True)
        xs = (x - mu) * torch.rsqrt(var + 1e-5) * lng + lnb
        basis = rbf.rbf_basis(xs, centers, h)
        return basis.reshape(n, -1) @ w.T + F.silu(x) @ wbase.T + bbase

    add("fastkan_layer_eager", layer_eager, flops_layer,
        bytes_layer_fused + 2 * 4 * n * d * (num_grids + 1))
    return rows


@dataclasses.dataclass
class DeviceProfile:
    """Per call of the function profiled: `ms` the summed device kernel
    time (None when the trace holds none: no CUDA device, or a profiler
    that sees no kernel); `kernels` (name, ms, launches) and `host`
    (operator, self CPU ms, calls), each longest first. The host times
    include the profiler's own cost."""
    ms: Optional[float]
    kernels: list[tuple[str, float, int]]
    host: list[tuple[str, float, int]]


def device_profile(run: Callable[[], None], n_calls: int) -> DeviceProfile:
    """Profile `run()`, which makes `n_calls` calls of the function
    measured, with torch.profiler; the times per call."""
    from torch.autograd import DeviceType
    from torch.profiler import profile

    with profile(activities=_activities()) as prof:
        run()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    events = prof.key_averages()

    def per_call(device_type, attr):
        rows = [(e.key, getattr(e, attr) / 1e3 / n_calls, e.count // n_calls)
                for e in events if e.device_type == device_type]
        return sorted(rows, key=lambda row: -row[1])

    kernels = per_call(DeviceType.CUDA, "self_device_time_total")
    total = sum(ms for _, ms, _ in kernels)
    return DeviceProfile(total if total else None, kernels,
                         per_call(DeviceType.CPU, "self_cpu_time_total"))


def launch_resources(run: Callable[[], None]) -> dict:
    """Each CUDA kernel that `run()` launches, by `kernel_base_name`: the
    registers a thread, the shared memory a block (bytes) and the estimated
    occupancy (%) of its last launch, as the profiler's trace records them
    (None where it records none)."""
    import json
    import os
    import tempfile

    from torch.profiler import profile

    with profile(activities=_activities()) as prof:
        run()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    return {kernel_base_name(e.get("name", "")): tuple(
                e.get("args", {}).get(k) for k in (
                    "registers per thread", "shared memory", "est. achieved occupancy %"))
            for e in events if e.get("cat") == "kernel"}


# The kernel rows by the CUDA function names of csrc/: each library's
# kernels carry its prefix, a layer forward's kernels (on the CUDA cores
# or the tensor cores) the stem `<prefix>_fwd`, and each GAT kernel's
# launches (the split rows' piece and combine kernels too) its row's stem;
# gin_fused's four kernels (the split aggregate's two, the forwards on the
# tensor cores and the CUDA cores) carry `gin_`, after gin_fastkan's.
# The first prefix a profiled name starts with decides its row. The tile walk (kan::walk_tiles_kernel)
# is shared by the three layer backwards and goes to the one the path
# launched.
KERNEL_NAMES = (("bspline_fwd", "bspline_fwd"), ("bspline_", "bspline_bwd"),
                ("gin_fastkan", "gin_fastkan"), ("gin_", "gin_fused"),
                ("fastkan_fwd", "fastkan_fwd"), ("fastkan_", "fastkan_bwd"),
                ("rbf_fwd", "rbf_fwd"), ("rbf_", "rbf_bwd"),
                ("gat_fwd", "gat_fwd"), ("gat_dadst", "gat_dadst"),
                ("gat_sender", "gat_sender"), ("gcn_", "gcn_agg"),
                ("spmm_csr", "spmm"), ("narrow_", "spmm_narrow"))


def kernel_base_name(key: str) -> str:
    """A profiled kernel name without its namespace, template arguments and
    parameters: `void (anonymous namespace)::bspline_fwd_mma_kernel<3,
    4>(...)` -> `bspline_fwd_mma_kernel`."""
    base = key.replace("void ", "").replace("(anonymous namespace)::", "")
    return base.replace("kan::", "").split("<")[0].split("(")[0].strip()


def kernel_row_of(key: str, launches: dict) -> Optional[str]:
    """The kernel row of a profiled kernel name on a path with `launches`
    (launches per kernel row), or None for PyTorch's own kernels."""
    base = kernel_base_name(key)
    if base == "walk_tiles_kernel":
        return next((r for r in ("bspline_bwd", "fastkan_bwd", "rbf_bwd")
                     if launches.get(r)), None)
    return next((row for prefix, row in KERNEL_NAMES if base.startswith(prefix)), None)
