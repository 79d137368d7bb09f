"""Device ms a step of the operations that are not the port's own kernels
(BatchNorm, casts, the loss, Adam, copies), from the traced sub-window by
name: every device operation whose base name starts with none of the port's
kernel families below."""
from port_bench import trace

# the name stems of kagnn_tpu_torch/csrc's kernels
PORT_KERNELS = ("bspline_", "gin_", "spmm_", "narrow_", "gcn_", "gat_", "fastkan_",
                "rbf_", "walk_tiles_")


def read(ctx):
    if not ctx.trace.device:
        return None
    ours = trace.group_s(ctx.trace, PORT_KERNELS)
    total = sum(i.end - i.start for i in ctx.trace.device) * 1e-6
    return 1e3 * (total - ours) / ctx.steps_traced
