"""`kagnn_tpu_torch/utils/profiling.py` on the CPU: the H100 peaks and
bound, a Chrome trace of a CPU region, the timer refusing the CPU (it times
CUDA kernels; the numbers it gives come only from a card, through
chip_smoke.py), the program's spans (nothing recorded without a profiler;
the train steps' and layers' spans nested as they run) and `span_report`
on traces written here."""
import json
import re
import threading
import timeit
from pathlib import Path

import numpy as np
import pytest
import torch

from kagnn_tpu_torch.graphs import single_graph
from kagnn_tpu_torch.models import NodeClassifier
from kagnn_tpu_torch.train import (make_node_multi_step, make_node_steps,
                                   masked_softmax_cross_entropy)
from kagnn_tpu_torch.train.loops import _graph_steps
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
    "bspline_dx_sum_kernel": "bspline_bwd",
    "fastkan_fwd_kernel": "fastkan_fwd", "fastkan_fwd_mma_kernel": "fastkan_fwd",
    "fastkan_stats_kernel": "fastkan_bwd", "fastkan_dx_kernel": "fastkan_bwd",
    "fastkan_tile_sums_kernel": "fastkan_bwd", "fastkan_row_sums_kernel": "fastkan_bwd",
    "fastkan_dx_sum_kernel": "fastkan_bwd", "fastkan_dw_mma_kernel": "fastkan_bwd",
    "fastkan_dw_partial_kernel": "fastkan_bwd",
    "gin_sum_kernel": "gin_fused", "gin_sum_combine_kernel": "gin_fused",
    "gin_fwd_kernel": "gin_fused", "gin_fwd_mma_kernel": "gin_fused",
    "gin_fastkan_sum_kernel": "gin_fastkan", "gin_fastkan_sum_combine_kernel": "gin_fastkan",
    "gin_fastkan_fwd_kernel": "gin_fastkan", "gin_fastkan_fwd_mma_kernel": "gin_fastkan",
    "rbf_fwd_kernel": "rbf_fwd", "rbf_fwd_mma_kernel": "rbf_fwd", "rbf_dx_kernel": "rbf_bwd",
    "rbf_dw_partial_kernel": "rbf_bwd", "rbf_dx_mma_kernel": "rbf_bwd",
    "rbf_dx_sum_kernel": "rbf_bwd", "rbf_dw_mma_kernel": "rbf_bwd",
    "gat_fwd_kernel": "gat_fwd", "gat_dadst_kernel": "gat_dadst",
    "gat_fwd_max_kernel": "gat_fwd", "gat_fwd_combine_kernel": "gat_fwd",
    "gat_dadst_combine_kernel": "gat_dadst",
    "gat_sender_kernel": "gat_sender", "gat_sender_combine_kernel": "gat_sender",
    "gcn_rows_kernel": "gcn_agg",
    "gcn_combine_kernel": "gcn_agg", "spmm_csr_kernel": "spmm",
    "spmm_csr_combine_kernel": "spmm",
    "narrow_row_ptr_kernel": "spmm_narrow", "narrow_sum_kernel": "spmm_narrow",
    "narrow_combine_kernel": "spmm_narrow", "walk_tiles_kernel": None,
    "masked_bn_stats_kernel": "masked_bn", "masked_bn_stats_final_kernel": "masked_bn",
    "masked_bn_apply_kernel": "masked_bn", "masked_bn_grad_stats_kernel": "masked_bn",
    "masked_bn_grad_final_kernel": "masked_bn", "masked_bn_dx_kernel": "masked_bn"}


def test_h100_peaks_and_bound():
    h = profiling.H100
    assert (h.flops_bf16, h.flops_f32, h.hbm_gbps) == (989e12, 67e12, 3.35e12)
    ms, by = h.bound_ms(3.35e9, 1e9, "bfloat16")  # 1 ms of bytes
    assert ms == pytest.approx(1.0) and by == "bytes"
    ms, by = h.bound_ms(0.0, 67e9, "float32")  # 1 ms of f32 operations
    assert ms == pytest.approx(1.0) and by == "operations"


def test_time_ms_needs_a_card():
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            profiling.time_ms(lambda: None)


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


def _spans(path) -> list[dict]:
    """The program's spans and torch's optimizer spans in a Chrome trace."""
    events = json.loads(Path(path).read_text())["traceEvents"]
    return [e for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation"
            and e["name"].startswith(profiling.SPAN_PREFIXES)]


def _inside(inner: dict, outer: dict) -> bool:
    return (inner["tid"] == outer["tid"] and outer["ts"] <= inner["ts"]
            and inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"])


def _small_model(conv):
    rng = np.random.default_rng(3)
    n, e = 24, 80
    g = single_graph(rng.integers(0, n, e), rng.integers(0, n, e),
                     nodes=rng.normal(size=(n, 6)).astype(np.float32),
                     y=rng.integers(0, 3, n), device="cpu")
    model = NodeClassifier(conv, "kan", 2, 6, 8, 3, heads=2, device="cpu")
    return g, model, torch.optim.Adam(model.parameters(), lr=1e-3)


def test_span_without_a_profiler_records_nothing_and_stays_cheap(monkeypatch, tmp_path):
    """With no profiler running `span` never reaches record_function, leaves
    nothing for a later trace, and costs a small part of what an entry and
    exit of record_function cost."""
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) reached without a profiler")

    with monkeypatch.context() as m:
        m.setattr(torch.profiler, "record_function", refuse)
        with profiling.span(profiling.STEP):
            pass
    with profiling.trace(str(tmp_path / "t")):
        torch.ones(4) + 1
    assert _spans(tmp_path / "t" / "trace.json") == []

    def spanned():
        with profiling.span(profiling.STEP):
            pass

    def recorded():
        with torch.profiler.record_function(profiling.STEP):
            pass

    n = 2000
    cost = min(timeit.repeat(spanned, number=n, repeat=5))
    full = min(timeit.repeat(recorded, number=n, repeat=5))
    assert cost < 0.25 * full, (cost / n * 1e6, full / n * 1e6)


@pytest.mark.parametrize("entry", ["make_node_steps", "_graph_steps"])
def test_train_step_spans_nest_on_the_calling_thread(entry, tmp_path):
    """One profiled train step records STEP on the calling thread with
    STEP_FORWARD, then STEP_BACKWARD and torch's Optimizer.step inside it;
    the layer spans lie in the forward; span_report reads them."""
    g, model, opt = _small_model("gat" if entry == "make_node_steps" else "gin")
    if entry == "make_node_steps":
        step = make_node_steps(model, opt)[0]
        run = lambda: step(g, g.node_mask)  # noqa: E731
    else:
        step = _graph_steps(model, opt, lambda out, b: masked_softmax_cross_entropy(
            out, b.y, b.node_mask))
        run = lambda: step(g)  # noqa: E731
    run()
    with profiling.trace(str(tmp_path / "t")):
        run()
    spans = _spans(tmp_path / "t" / "trace.json")
    by_name = lambda n: [e for e in spans if e["name"] == n]  # noqa: E731
    (outer,) = by_name(profiling.STEP)
    assert outer["tid"] == threading.get_native_id()
    (fwd,), (bwd,) = by_name(profiling.STEP_FORWARD), by_name(profiling.STEP_BACKWARD)
    (adam,) = [e for e in spans if e["name"].startswith("Optimizer.step#")]
    assert _inside(fwd, outer) and _inside(bwd, outer) and _inside(adam, outer)
    assert fwd["ts"] + fwd["dur"] <= bwd["ts"] and bwd["ts"] + bwd["dur"] <= adam["ts"]
    layers = by_name(profiling.KAN_LAYER) + by_name(profiling.MESSAGE_PASSING)
    assert by_name(profiling.KAN_LAYER) and by_name(profiling.MESSAGE_PASSING)
    assert all(_inside(e, fwd) for e in layers)
    report = profiling.span_report(str(tmp_path / "t" / "trace.json"))
    assert report[profiling.STEP]["count"] == 1
    assert report[profiling.STEP]["host_ms"] >= (report[profiling.STEP_FORWARD]["host_ms"]
                                                 + report[profiling.STEP_BACKWARD]["host_ms"])
    assert report[profiling.ALL]["count"] == 0  # no device on the CPU


def test_multi_step_on_the_cpu_records_its_span_around_its_steps(tmp_path):
    g, model, opt = _small_model("gin")
    multi = make_node_multi_step(model, opt, 2)
    with profiling.trace(str(tmp_path / "t")):
        multi(g, g.node_mask)
    spans = _spans(tmp_path / "t" / "trace.json")
    (outer,) = [e for e in spans if e["name"] == profiling.MULTI_STEP]
    steps = [e for e in spans if e["name"] == profiling.STEP]
    assert len(steps) == 2 and all(_inside(e, outer) for e in steps)
    assert not [e for e in spans if e["name"].startswith(profiling.MULTI_STEP + ".")]


def _x(cat, name, ts, dur, tid, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 1, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


MAIN, AUTOGRAD, STREAM = 1, 2, 7
# a step on the main thread: a forward holding a KAN layer, the backward
# (whose kernels autograd's thread launches, two of them overlapping on two
# streams), Adam; a copy after the step that no span encloses
SYNTHETIC = [
    _x("user_annotation", profiling.STEP, 0, 100, MAIN),
    _x("user_annotation", profiling.STEP_FORWARD, 5, 35, MAIN),
    _x("user_annotation", profiling.KAN_LAYER, 10, 20, MAIN),
    _x("user_annotation", profiling.STEP_BACKWARD, 45, 35, MAIN),
    _x("user_annotation", "Optimizer.step#Adam.step", 85, 10, MAIN),
    _x("user_annotation", "other.span", 0, 200, MAIN),
    _x("cuda_runtime", "cudaLaunchKernel", 12, 1, MAIN, 1),
    _x("kernel", "bspline_fwd_mma_kernel", 20, 10, STREAM, 1),
    _x("cuda_runtime", "cudaLaunchKernel", 35, 1, MAIN, 2),
    _x("kernel", "vectorized_elementwise_kernel", 30, 6, STREAM, 2),
    _x("cuda_runtime", "cudaLaunchKernel", 50, 1, AUTOGRAD, 3),
    _x("kernel", "bspline_dw_mma_kernel", 50, 20, STREAM, 3),
    _x("cuda_runtime", "cudaLaunchKernel", 52, 1, AUTOGRAD, 4),
    _x("kernel", "bspline_dx_mma_kernel", 55, 20, STREAM + 1, 4),
    _x("cuda_runtime", "cudaLaunchKernel", 88, 1, MAIN, 5),
    _x("kernel", "multi_tensor_apply_kernel", 88, 4, STREAM, 5),
    _x("cuda_runtime", "cudaMemcpyAsync", 110, 15, MAIN, 6),
    _x("gpu_memcpy", "Memcpy DtoH (Device -> Pinned)", 120, 5, STREAM, 6),
    _x("cuda_runtime", "cudaLaunchKernel", 130, 1, AUTOGRAD, 7),
    _x("kernel", "reduce_kernel", 130, 2, STREAM, 7),
]


@pytest.fixture
def synthetic_path(tmp_path):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": SYNTHETIC}))
    return str(path)


@pytest.fixture
def synthetic(synthetic_path):
    return profiling.span_report(synthetic_path)


def test_span_report_gives_each_kernel_to_the_span_that_launched_it(synthetic):
    r = synthetic
    assert "other.span" not in r
    assert r[profiling.KAN_LAYER]["device_ms"] == pytest.approx(0.010)
    assert r[profiling.STEP_FORWARD]["self_device_ms"] == pytest.approx(0.006)
    assert r[profiling.STEP_FORWARD]["device_ms"] == pytest.approx(0.016)
    assert r["Optimizer.step#Adam.step"]["device_ms"] == pytest.approx(0.004)
    assert r[profiling.STEP]["self_device_ms"] == 0.0
    assert r[profiling.STEP]["count"] == 1
    assert r[profiling.STEP]["host_ms"] == pytest.approx(0.100)
    assert r[profiling.STEP_FORWARD]["host_ms"] == pytest.approx(0.035)
    # the copy and the late launch of autograd's thread lie outside every span
    assert r[profiling.OUTSIDE]["device_ms"] == pytest.approx(0.007)


def test_span_report_puts_another_threads_launch_under_the_main_span(synthetic):
    """Autograd's thread opens no span: its launches go to the span the main
    thread has open, the backward, and to what encloses it."""
    assert synthetic[profiling.STEP_BACKWARD]["self_device_ms"] == pytest.approx(0.025)
    assert synthetic[profiling.STEP]["device_ms"] == pytest.approx(0.010 + 0.006 + 0.025 + 0.004)


def test_span_report_counts_overlapping_kernels_once(synthetic, synthetic_path):
    """The backward's two kernels overlap on two streams (50-70, 55-75): 25
    µs busy, 40 summed; the phases add up to the union of every device
    interval and, summed, to the summed durations.
    With `keep` only the kernels it accepts are read."""
    r = synthetic
    assert r[profiling.STEP_BACKWARD]["device_ms"] == pytest.approx(0.025)
    assert r[profiling.STEP_BACKWARD]["summed_device_ms"] == pytest.approx(0.040)
    assert r[profiling.ALL]["device_ms"] == pytest.approx(0.052)
    assert r[profiling.ALL]["summed_device_ms"] == pytest.approx(0.067)
    assert r[profiling.ALL]["count"] == 7
    phases = (r[profiling.STEP_FORWARD]["device_ms"] + r[profiling.STEP_BACKWARD]["device_ms"]
              + r["Optimizer.step#Adam.step"]["device_ms"] + r[profiling.OUTSIDE]["device_ms"])
    assert phases == pytest.approx(r[profiling.ALL]["device_ms"])
    summed = sum(r[n]["summed_device_ms"] for n in (
        profiling.STEP_FORWARD, profiling.STEP_BACKWARD, "Optimizer.step#Adam.step",
        profiling.OUTSIDE))
    assert summed == pytest.approx(r[profiling.ALL]["summed_device_ms"])
    kept = profiling.span_report(synthetic_path, keep=lambda n: n.startswith("bspline_"))
    assert kept[profiling.ALL]["count"] == 3
    assert kept[profiling.STEP_BACKWARD]["device_ms"] == pytest.approx(0.025)
    assert kept[profiling.STEP_FORWARD]["device_ms"] == pytest.approx(0.010)
