"""`kagnn_tpu_torch/utils/profiling.py` on the CPU: the roofline arithmetic
and its row fields on numbers given here, the H100 peaks and bound, a
Chrome trace of a CPU region, and the timers refusing the CPU (they time
CUDA kernels; the numbers they give come only from a card, through
chip_smoke.py)."""
import json
import re
from pathlib import Path

import pytest
import torch

from kagnn_tpu_torch.utils import profiling

torch.set_num_threads(1)

CSRC = Path(profiling.__file__).resolve().parent.parent / "csrc"
# each CUDA kernel of csrc/ and its row of the kernel table (PERF.md §6);
# the tile walk is shared by the layer backwards (kernel_row_of gives it to
# the one the path launched)
KERNEL_ROWS = {
    "bspline_fwd_kernel": "bspline_fwd", "bspline_fwd_mma_kernel": "bspline_fwd",
    "bspline_dx_kernel": "bspline_bwd", "bspline_dx_mma_kernel": "bspline_bwd",
    "bspline_dw_partial_kernel": "bspline_bwd", "bspline_dw_mma_kernel": "bspline_bwd",
    "fastkan_fwd_kernel": "fastkan_fwd", "fastkan_fwd_mma_kernel": "fastkan_fwd",
    "fastkan_stats_kernel": "fastkan_bwd", "fastkan_dx_kernel": "fastkan_bwd",
    "fastkan_tile_sums_kernel": "fastkan_bwd", "fastkan_row_sums_kernel": "fastkan_bwd",
    "fastkan_dx_sum_kernel": "fastkan_bwd", "fastkan_dw_mma_kernel": "fastkan_bwd",
    "fastkan_dw_partial_kernel": "fastkan_bwd",
    "gin_sum_kernel": "gin_fused", "gin_sum_combine_kernel": "gin_fused",
    "gin_fwd_kernel": "gin_fused", "gin_fwd_mma_kernel": "gin_fused",
    "gin_fastkan_kernel": "gin_fastkan",
    "rbf_fwd_kernel": "rbf_fwd", "rbf_dx_kernel": "rbf_bwd",
    "rbf_dw_partial_kernel": "rbf_bwd", "rbf_dx_mma_kernel": "rbf_bwd",
    "rbf_dx_sum_kernel": "rbf_bwd", "rbf_dw_mma_kernel": "rbf_bwd",
    "gat_fwd_kernel": "gat_fwd", "gat_dadst_kernel": "gat_dadst",
    "gat_fwd_max_kernel": "gat_fwd", "gat_fwd_combine_kernel": "gat_fwd",
    "gat_dadst_combine_kernel": "gat_dadst",
    "gat_sender_kernel": "gat_sender", "gat_sender_combine_kernel": "gat_sender",
    "gcn_rows_kernel": "gcn_agg",
    "gcn_combine_kernel": "gcn_agg", "spmm_csr_kernel": "spmm",
    "spmm_csr_combine_kernel": "spmm",
    "narrow_kernel": "spmm_narrow", "walk_tiles_kernel": None}


def test_roofline_arithmetic_and_row_fields():
    peaks = profiling.HardwarePeaks("card", flops_bf16=100e12,
                                    flops_f32=10e12, hbm_gbps=1e12)
    r = profiling.Roofline("k", flops=2e12, bytes_accessed=4e11, seconds=0.5,
                           peaks=peaks)
    assert r.achieved_flops == 4e12 and r.achieved_gbps == 8e11
    assert r.compute_util == pytest.approx(0.4)  # f32 peak
    assert r.bandwidth_util == pytest.approx(0.8)
    assert r.bound == "hbm"
    assert r.row() == {"kernel": "k", "seconds": 0.5, "tflops": 4.0,
                       "gbps": 800.0, "compute_util": 0.4,
                       "bandwidth_util": 0.8, "bound": "hbm", "hw": "card"}
    bf = profiling.Roofline("k", 2e12, 4e9, 0.5, peaks, dtype="bf16")
    assert bf.compute_util == pytest.approx(0.04) and bf.bound == "compute"


def test_h100_peaks_and_bound():
    h = profiling.H100
    assert (h.flops_bf16, h.flops_f32, h.hbm_gbps) == (989e12, 67e12, 3.35e12)
    assert profiling.Roofline("k", 1.0, 1.0, 1.0).peaks is h
    ms, by = h.bound_ms(3.35e9, 1e9, "bfloat16")  # 1 ms of bytes
    assert ms == pytest.approx(1.0) and by == "bytes"
    ms, by = h.bound_ms(0.0, 67e9, "float32")  # 1 ms of f32 operations
    assert ms == pytest.approx(1.0) and by == "operations"


def test_kernel_report_and_time_ms_need_a_card():
    with pytest.raises(ValueError, match="no kernel to time"):
        profiling.kernel_report(n=64, iters=1, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            profiling.time_ms(lambda: None)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            profiling.kernel_report(n=64, iters=1)


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path / "t")):
        torch.ones(64, 64) @ torch.ones(64, 64)
    events = json.loads((tmp_path / "t" / "trace.json").read_text())["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)


def test_device_profile_without_device_time_is_none():
    """A run of CPU work only has no device time to report; its host
    operators are listed per call, longest first."""
    prof = profiling.device_profile(
        lambda: [torch.ones(8, 8) @ torch.ones(8, 8) for _ in range(4)], 2)
    assert prof.ms is None and prof.kernels == []
    assert ("aten::mm", 2) in [(k, n) for k, _, n in prof.host]
    assert [ms for _, ms, _ in prof.host] == sorted(
        (ms for _, ms, _ in prof.host), reverse=True)


def test_every_cuda_kernel_name_finds_its_row():
    """Each `__global__` function of csrc/, as torch.profiler names it (in
    an anonymous namespace or kan::, with template arguments and
    parameters), goes to its kernel row: the tensor-core forwards to the
    forwards' rows, not to the backwards' that share their library's
    prefix; the tile walk to the backward the path launched."""
    text = "\n".join(f.read_text() for f in sorted(CSRC.glob("*.cu*")))
    names = set(re.findall(
        r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?(\w+)", text))
    assert names == set(KERNEL_ROWS)
    for name in names:
        ns = "kan::" if name == "walk_tiles_kernel" else "(anonymous namespace)::"
        key = f"void {ns}{name}<float, 4>(float const*, int)"
        assert profiling.kernel_base_name(key) == name
        if name == "walk_tiles_kernel":
            for row in ("bspline_bwd", "fastkan_bwd", "rbf_bwd"):
                assert profiling.kernel_row_of(key, {row: 4, "spmm": 2}) == row
            assert profiling.kernel_row_of(key, {"spmm": 2}) is None
        else:
            assert profiling.kernel_row_of(key, {}) == KERNEL_ROWS[name], name
    assert profiling.kernel_row_of("void at::native::vectorized_elementwise_kernel<4>()",
                                   {}) is None
