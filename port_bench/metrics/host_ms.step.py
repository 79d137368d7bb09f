"""Host ms a step inside the program's step spans, `kagnn.step` (an eager
train step) and `kagnn.multi_step` (a call of the multi-step entry): the
union of their intervals on the traced thread, clipped to the traced
sub-window, over its steps. The inside counterpart of `host_enqueue_ms`,
read under the profiler, so its own cost a recorded operation is in it."""
from port_bench import trace

SPANS = ("kagnn.step", "kagnn.multi_step")


def read(ctx):
    lo, hi = ctx.trace.window
    host = [h for h in ctx.trace.host if h.end > lo and h.start < hi]
    if not any(h.name.startswith("kagnn.") for h in host):
        return None  # a program that records no span of its own
    spans = [(max(h.start, lo), min(h.end, hi)) for h in host if h.name in SPANS]
    return sum(b - a for a, b in trace.union(spans)) * 1e-3 / ctx.steps_traced
