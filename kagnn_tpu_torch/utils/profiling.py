"""Profiling on the card, the port of `kagnn_tpu/utils/profiling.py`:

  * `trace(logdir)` — a torch.profiler trace of the host and the card,
    written as a Chrome trace (`logdir/trace.json`, for Perfetto);
  * `span(name)` — a named span of the program on the profiler's clock,
    recorded only while a profiler runs, and the names of the program's
    spans (`STEP`, `STEP_FORWARD`, ...);
  * `span_report(trace_json)` — host and device ms by span from a trace
    that `trace` wrote;
  * `HardwarePeaks`, `H100` — published peaks, and `bound_ms`, the least
    time a card could take for some bytes and operations;
  * `time_ms(fn)` — a function's time on the card from CUDA events;
  * `device_profile(run, n_calls)` — device kernel time per call, in all
    and by kernel, and the host operators' self time, from torch.profiler;
  * `kernel_row_of(key, launches)` — the kernel row (PERF.md §6) of a
    profiled CUDA kernel name.

Nothing here times the CPU: `time_ms` raises without a CUDA device, where
there is no kernel to time.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
from pathlib import Path
from typing import Callable, Optional

import torch
import torch.autograd.profiler as _autograd_profiler

# The program's spans, `kagnn.<layer>[.<part>]`. An eager train step
# (`train/loops.py`: `make_node_steps`, the graph steps) is STEP, holding
# STEP_FORWARD (the model and the loss), STEP_BACKWARD and torch's own
# `Optimizer.zero_grad#...` and `Optimizer.step#...` spans; a call of
# `make_node_multi_step`'s entry is MULTI_STEP, holding on the card
# MULTI_STEP_CAPTURE (a signature's first call: warm-up and capture),
# MULTI_STEP_COPY_IN (the batch copied into the capture's inputs) and
# MULTI_STEP_REPLAY. The layer spans cover forwards only: KAN_LAYER a
# `KANLinear` or `FastKANLayer` (a fused GIN entry, aggregation included),
# MESSAGE_PASSING `ops/segment.py`'s neighbor_sum, gcn_aggregate and
# gat_attention, NORM a `MaskedBatchNorm`.
STEP = "kagnn.step"
STEP_FORWARD = "kagnn.step.forward"
STEP_BACKWARD = "kagnn.step.backward"
MULTI_STEP = "kagnn.multi_step"
MULTI_STEP_CAPTURE = "kagnn.multi_step.capture"
MULTI_STEP_COPY_IN = "kagnn.multi_step.copy_in"
MULTI_STEP_REPLAY = "kagnn.multi_step.replay"
KAN_LAYER = "kagnn.kan_layer"
MESSAGE_PASSING = "kagnn.message_passing"
NORM = "kagnn.norm"
# torch.optim's own spans, `Optimizer.step#Adam.step` and the like
OPTIMIZER_SPANS = ("Optimizer.step", "Optimizer.zero_grad")
# the spans `span_report` reads, by name prefix
SPAN_PREFIXES = ("kagnn.",) + OPTIMIZER_SPANS


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, exc_type, exc, tb):
        return None


_NO_SPAN = _NoSpan()


def span(name: str):
    """A context manager: `torch.profiler.record_function(name)` while a
    profiler runs, else one that does nothing (no call into the profiler,
    nothing recorded, nothing captured into a CUDA graph)."""
    if _autograd_profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _NO_SPAN


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


# a device activity's chrome-trace categories, and its launch's
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
# span_report's rows for the device work that no span encloses, and for all
# of it
OUTSIDE, ALL = "(outside spans)", "(all)"


def _union_ms(intervals) -> float:
    """The length of the union of (start, end) µs intervals, in ms."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total * 1e-3


def _summed_ms(intervals) -> float:
    return sum(b - a for a, b in intervals) * 1e-3


def span_report(trace_json: str, keep: Optional[Callable[[str], bool]] = None) -> dict:
    """Host and device ms by span, from a Chrome trace that `trace` wrote:
    {name: {"count", "host_ms", "device_ms", "self_device_ms",
    "summed_device_ms"}} for every span whose name starts with one of
    SPAN_PREFIXES, plus the rows OUTSIDE (device work no span encloses) and ALL
    (every device interval; its `count` the intervals).

    `host_ms` is the union of the name's intervals. Each kernel, copy or
    fill goes, by its correlation id, to the innermost span that encloses
    its launch on the launching thread; a launch that no span of its thread
    encloses (autograd's backward thread on the card) to the innermost span
    of the main thread (the thread of the longest span) open at that
    moment. `self_device_ms` is the union of the device intervals given to
    the name itself, `device_ms` of those given to it or to a span nested in
    it, `summed_device_ms` the summed durations of the latter. Each device
    interval goes to one innermost span, so the rows of disjoint spans add
    up: their `summed_device_ms` to ALL's, their `device_ms`, in which
    kernels that overlap (two streams, a CUDA graph's concurrent nodes)
    count once, to ALL's unless kernels of two of them overlap. With
    `keep`, only the device activities whose name it accepts are read."""
    with open(trace_json) as f:
        events = [e for e in json.load(f).get("traceEvents", [])
                  if e.get("ph") == "X" and "dur" in e]
    spans: dict = {}  # thread -> [(start, end, name)]
    launches, device = {}, []
    for e in events:
        cat, ts, dur = e.get("cat"), float(e["ts"]), float(e["dur"])
        thread = (e.get("pid"), e.get("tid"))
        corr = e.get("args", {}).get("correlation")
        if cat == "user_annotation" and e.get("name", "").startswith(SPAN_PREFIXES):
            spans.setdefault(thread, []).append((ts, ts + dur, e["name"]))
        elif cat in _LAUNCH_CATS and corr is not None:
            launches[corr] = (thread, ts)
        elif cat in _DEVICE_CATS and (keep is None or keep(e.get("name", ""))):
            device.append((corr, ts, ts + dur))
    main = max(((b - a, t) for t, ss in spans.items() for a, b, _ in ss),
               default=(0.0, None))[1]

    def enclosing(thread, t):
        """The names of the spans of `thread` open at t, innermost first."""
        open_ = [(b - a, n) for a, b, n in spans.get(thread, ()) if a <= t < b]
        return [n for _, n in sorted(open_)]

    self_iv: dict = {}
    incl_iv: dict = {}
    for corr, a, b in device:
        names = []
        if corr in launches:
            thread, t = launches[corr]
            names = enclosing(thread, t) or (enclosing(main, t) if thread != main else [])
        self_iv.setdefault(names[0] if names else OUTSIDE, []).append((a, b))
        for n in set(names):
            incl_iv.setdefault(n, []).append((a, b))
    report = {}
    for ss in spans.values():
        for a, b, n in ss:
            report.setdefault(n, {"count": 0, "host": []})
            report[n]["count"] += 1
            report[n]["host"].append((a, b))
    for n, row in report.items():
        report[n] = {"count": row["count"], "host_ms": _union_ms(row["host"]),
                     "device_ms": _union_ms(incl_iv.get(n, ())),
                     "self_device_ms": _union_ms(self_iv.get(n, ())),
                     "summed_device_ms": _summed_ms(incl_iv.get(n, ()))}
    outside = self_iv.get(OUTSIDE, ())
    report[OUTSIDE] = {"count": 0, "host_ms": 0.0, "device_ms": _union_ms(outside),
                       "self_device_ms": _union_ms(outside),
                       "summed_device_ms": _summed_ms(outside)}
    every = [(a, b) for _, a, b in device]
    report[ALL] = {"count": len(every), "host_ms": 0.0, "device_ms": _union_ms(every),
                   "self_device_ms": _union_ms(every), "summed_device_ms": _summed_ms(every)}
    return report


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
# tensor cores and the CUDA cores) carry `gin_`, after gin_fastkan's;
# the fused BatchNorm's six carry `masked_bn_` (a row with no TPU kernel).
# The first prefix a profiled name starts with decides its row. The tile walk (kan::walk_tiles_kernel)
# is shared by the three layer backwards and goes to the one the path
# launched.
KERNEL_NAMES = (("bspline_fwd", "bspline_fwd"), ("bspline_", "bspline_bwd"),
                ("gin_fastkan", "gin_fastkan"), ("gin_", "gin_fused"),
                ("fastkan_fwd", "fastkan_fwd"), ("fastkan_", "fastkan_bwd"),
                ("rbf_fwd", "rbf_fwd"), ("rbf_", "rbf_bwd"),
                ("gat_fwd", "gat_fwd"), ("gat_dadst", "gat_dadst"),
                ("gat_sender", "gat_sender"), ("gcn_", "gcn_agg"),
                ("spmm_csr", "spmm"), ("narrow_", "spmm_narrow"),
                ("masked_bn_", "masked_bn"))


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
