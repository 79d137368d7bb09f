"""Host ms a step inside torch.optim's own spans, `Optimizer.step#...` and
`Optimizer.zero_grad#...` (matched by prefix): the union of their intervals
on the traced thread, clipped to the traced sub-window, over its steps: 0
in a captured cell, whose replay runs no host code."""
from port_bench import trace

PREFIXES = ("Optimizer.step", "Optimizer.zero_grad")


def read(ctx):
    lo, hi = ctx.trace.window
    host = [h for h in ctx.trace.host if h.end > lo and h.start < hi]
    if not any(h.name.startswith("kagnn.") for h in host):
        return None  # a program that records no span of its own
    spans = [(max(h.start, lo), min(h.end, hi)) for h in host
             if h.name.startswith(PREFIXES)]
    return sum(b - a for a, b in trace.union(spans)) * 1e-3 / ctx.steps_traced
