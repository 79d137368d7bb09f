"""% of its roofline the step's message passing reaches: the least time the
aggregations need (port_bench/work.py::message_passing, at the H100's peaks)
over the device time of the kernels that do them, a step."""
from port_bench import trace, work

# GIN's aggregate pass of gin_fused and the A^T dz segment sum; the GAT
# forward, its dalpha_dst and sender-side backward passes; GCN's aggregate;
# the narrow segment sum
KERNELS = ("gin_sum", "gin_fastkan_sum", "spmm_csr", "gat_fwd", "gat_dadst",
           "gat_sender", "gcn_", "narrow_")


def read(ctx):
    items = work.message_passing(ctx.config, ctx.graph)
    spent = trace.group_s(ctx.trace, KERNELS) / ctx.steps_traced
    if items is None or spent <= 0:
        return None
    least = work.least_ms(items, ctx.config["compute_dtype"]) * 1e-3
    return 100.0 * least / spent
