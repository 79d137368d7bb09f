"""% of the traced sub-window in which nothing ran on the device: one minus
the union of the device's activity intervals (kernels, copies, fills) over
the window's length, never summed kernel times."""
from port_bench import trace


def read(ctx):
    if not ctx.trace.device:
        return None
    return 100.0 * (1.0 - trace.busy_s(ctx.trace) / ctx.trace.window_s)
