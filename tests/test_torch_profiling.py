"""`kagnn_tpu_torch/utils/profiling.py` on the CPU: the roofline arithmetic
and its row fields on numbers given here, the H100 peaks and bound, a
Chrome trace of a CPU region, and the timers refusing the CPU (they time
CUDA kernels; the numbers they give come only from a card, through
chip_smoke.py)."""
import json

import pytest
import torch

from kagnn_tpu_torch.utils import profiling

torch.set_num_threads(1)


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
