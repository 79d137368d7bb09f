"""Device idle ms a step inside the program's step spans: the stretches of
the traced sub-window in which nothing ran on the device
(`trace.idle_gaps`), intersected with the union of `kagnn.step` and
`kagnn.multi_step` on the traced thread, over its steps. The idle time the
program's own host work leaves; the rest of `device_idle_share` lies in the
caller's loop between steps."""
from port_bench import trace

SPANS = ("kagnn.step", "kagnn.multi_step")


def read(ctx):
    lo, hi = ctx.trace.window
    host = [h for h in ctx.trace.host if h.end > lo and h.start < hi]
    if not ctx.trace.device or not any(h.name.startswith("kagnn.") for h in host):
        return None  # no device work, or a program that records no span of its own
    spans = trace.union((max(h.start, lo), min(h.end, hi)) for h in host if h.name in SPANS)
    idle = sum(max(0.0, min(b, d) - max(a, c))
               for a, b in trace.idle_gaps(ctx.trace) for c, d in spans)
    return idle * 1e-3 / ctx.steps_traced
