"""% of the H100's dense bf16 peak (989 TFLOP/s at 700 W) that the operations
a train step needs (port_bench/work.py::model_flops) make at the traced
run's `step_ms` (its untraced timed window)."""
from port_bench import work


def read(ctx):
    flops = work.model_flops(ctx.config, ctx.graph)
    return 100.0 * flops / (ctx.step_ms * 1e-3) / work.PEAK_FLOPS[ctx.config["compute_dtype"]]
