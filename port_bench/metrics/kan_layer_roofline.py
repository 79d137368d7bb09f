"""% of its roofline the step's KANLinear forwards and backwards reach: the
least time they need (port_bench/work.py::kan_layer, at the H100's peaks)
over the device time of the kernels that do them, a step."""
from port_bench import trace, work

# the B-spline forward and backward kernels, the layer pass of gin_fused,
# the backward's tile walk of the weight gradients
KERNELS = ("bspline_", "gin_fwd", "walk_tiles")


def read(ctx):
    spent = trace.group_s(ctx.trace, KERNELS) / ctx.steps_traced
    if spent <= 0:
        return None
    least = work.least_ms(work.kan_layer(ctx.config, ctx.graph),
                          ctx.config["compute_dtype"]) * 1e-3
    return 100.0 * least / spent
