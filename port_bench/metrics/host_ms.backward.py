"""Host ms a step inside the eager train step's backward span,
`kagnn.step.backward` (`loss.backward()`): the union of its intervals on
the traced thread, clipped to the traced sub-window, over its steps: 0 in a
captured cell, whose replay runs no host code. On the card autograd runs
the backward on a thread of its own, so this includes the traced thread's
wait for it."""
from port_bench import trace

SPANS = ("kagnn.step.backward",)


def read(ctx):
    lo, hi = ctx.trace.window
    host = [h for h in ctx.trace.host if h.end > lo and h.start < hi]
    if not any(h.name.startswith("kagnn.") for h in host):
        return None  # a program that records no span of its own
    spans = [(max(h.start, lo), min(h.end, hi)) for h in host if h.name in SPANS]
    return sum(b - a for a, b in trace.union(spans)) * 1e-3 / ctx.steps_traced
