"""Reading a torch.profiler trace of the traced sub-window.

The device's busy time is the length of the union of its activity intervals
(kernels, copies, fills) inside the window, never their summed durations:
kernels on two streams overlap, and a sum over a host-clock window that does
not wait for the card can read above the window.
"""
from __future__ import annotations

import dataclasses
import json
import re

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")


@dataclasses.dataclass
class Interval:
    name: str
    start: float  # µs, the trace's clock
    end: float


@dataclasses.dataclass
class Trace:
    window: tuple[float, float]  # µs
    device: list[Interval]  # clipped to the window
    host: list[Interval]  # the main thread's operations, unclipped

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-6


def base_name(name: str) -> str:
    """A device operation's name without return type, namespaces, template
    arguments and parameters: `void (anonymous namespace)::bspline_fwd_mma_kernel<3,
    4>(...)` -> `bspline_fwd_mma_kernel`."""
    name = re.sub(r"^void ", "", name.strip()).replace("(anonymous namespace)::", "")
    head = re.split(r"[<(]", name, maxsplit=1)[0]
    return head.split("::")[-1].strip() or name


def load(path: str, window_name: str) -> Trace:
    """The device intervals inside the span named `window_name` (a
    user annotation the run records around the traced units) and the host
    operations of the thread that recorded it."""
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    spans = [e for e in events if e.get("cat") == "user_annotation"
             and e.get("name") == window_name and "dur" in e]
    if not spans:
        raise ValueError(f"the trace has no span {window_name!r}")
    span = spans[0]
    lo, hi = float(span["ts"]), float(span["ts"]) + float(span["dur"])
    device, host = [], []
    for e in events:
        if "dur" not in e or e.get("ph") != "X":
            continue
        a, b = float(e["ts"]), float(e["ts"]) + float(e["dur"])
        if e.get("cat") in DEVICE_CATS:
            a, b = max(a, lo), min(b, hi)
            if b > a:
                device.append(Interval(e.get("name", ""), a, b))
        elif e.get("cat") in HOST_CATS and e.get("tid") == span.get("tid") \
                and e is not span and b > lo and a < hi:
            host.append(Interval(e.get("name", ""), a, b))
    return Trace((lo, hi), device, host)


def union(intervals) -> list[tuple[float, float]]:
    """The union of (start, end) intervals, as sorted disjoint intervals."""
    out = []
    for a, b in sorted((i.start, i.end) if isinstance(i, Interval) else i
                       for i in intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [tuple(x) for x in out]


def busy_s(trace: Trace) -> float:
    return sum(b - a for a, b in union(trace.device)) * 1e-6


def idle_gaps(trace: Trace) -> list[tuple[float, float]]:
    """The stretches of the window in which nothing ran on the device."""
    gaps, at = [], trace.window[0]
    for a, b in union(trace.device):
        if a > at:
            gaps.append((at, a))
        at = max(at, b)
    if trace.window[1] > at:
        gaps.append((at, trace.window[1]))
    return gaps


def host_doing(trace: Trace, t: float) -> str:
    """The innermost host operation running at time t, or "host idle"."""
    inside = [h for h in trace.host if h.start <= t < h.end]
    return min(inside, key=lambda h: h.end - h.start).name if inside else "host idle"


def breakdown(trace: Trace, top: int = 10) -> dict:
    """The device operations that took most time, and the idle time summed
    by what the host was doing at the middle of each gap; seconds, at most
    `top` entries each."""
    ops: dict[str, float] = {}
    for i in trace.device:
        key = base_name(i.name)
        ops[key] = ops.get(key, 0.0) + (i.end - i.start) * 1e-6
    idle: dict[str, float] = {}
    for a, b in idle_gaps(trace):
        key = host_doing(trace, (a + b) / 2)
        idle[key] = idle.get(key, 0.0) + (b - a) * 1e-6
    order = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]  # noqa: E731
    return {"device_ops": order(ops), "idle_gaps": order(idle)}


def group_s(trace: Trace, prefixes) -> float:
    """Summed seconds of the device operations whose base name starts with
    one of `prefixes` (a group's kernels may overlap; their sum is the time
    the group's work took of the card's streams)."""
    return sum(i.end - i.start for i in trace.device
               if base_name(i.name).startswith(tuple(prefixes))) * 1e-6
