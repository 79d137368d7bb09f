"""Hand-written Hopper kernels of the port, one module per TPU kernel module
of `kagnn_tpu/pallas/`, each with its plain PyTorch version and a launch
counter. Sources: `kagnn_tpu_torch/csrc/`; build: `_build.py`."""


def launch_counters() -> dict:
    """Every kernel wrapper by its kernel row (PERF.md §6): its `launches`
    counts the calls that launched its kernel (`masked_bn`, which has no
    TPU row: its forwards and its backwards)."""
    from kagnn_tpu_torch.kernels import bspline_fused as bf
    from kagnn_tpu_torch.kernels import fastkan_layer as fk
    from kagnn_tpu_torch.kernels import gat_bwd as gbw
    from kagnn_tpu_torch.kernels import gat_fused as gfu
    from kagnn_tpu_torch.kernels import gcn_agg as ga
    from kagnn_tpu_torch.kernels import gin_fastkan as gfk
    from kagnn_tpu_torch.kernels import gin_fused as gf
    from kagnn_tpu_torch.kernels import masked_bn as bn
    from kagnn_tpu_torch.kernels import rbf_fused as rf
    from kagnn_tpu_torch.kernels import spmm

    return {"spmm": spmm.sorted_segment_sum, "bspline_fwd": bf.kan_linear_fwd,
            "bspline_bwd": bf.kan_linear_bwd, "gin_fused": gf.gin_kan_fwd,
            "gcn_agg": ga.gcn_agg_fwd, "fastkan_fwd": fk.fastkan_layer_fwd,
            "fastkan_bwd": fk.fastkan_layer_bwd,
            "gin_fastkan": gfk.gin_fastkan_fwd, "gat_fwd": gfu.gat_fwd,
            "gat_dadst": gbw.gat_dadst, "gat_sender": gbw.gat_sender,
            "rbf_fwd": rf.rbf_spline_fwd, "rbf_bwd": rf.rbf_spline_bwd,
            "spmm_narrow": spmm.sorted_segment_sum_narrow,
            "masked_bn": bn.masked_bn}
