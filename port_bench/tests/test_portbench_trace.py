"""The device's busy time is the union of its intervals, not their sum."""
import json

import pytest

from port_bench import trace


def _trace(tmp_path, events):
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return trace.load(str(path), "w")


def _x(cat, name, ts, dur, tid=1):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid, "pid": 1}


EVENTS = [
    _x("user_annotation", "w", 100.0, 100.0),
    # two streams: 110-150 and 120-160 overlap; 170-190; one starting before
    # the window and one ending after it are clipped
    _x("kernel", "void (anonymous namespace)::bspline_dw_mma_kernel<3, 4>(float*)", 110, 40, 7),
    _x("kernel", "void kan::walk_tiles_kernel<float, __nv_bfloat16>(int)", 120, 40, 8),
    _x("kernel", "void at::native::vectorized_elementwise_kernel<4>(int)", 170, 20, 7),
    _x("kernel", "void at::native::reduce_kernel<512, 1>(int)", 90, 15, 7),
    _x("gpu_memcpy", "Memcpy DtoD (Device -> Device)", 195, 30, 7),
    _x("cpu_op", "aten::copy_", 160, 8),
    _x("cuda_runtime", "cudaLaunchKernel", 162, 2),
]


def test_idle_share_from_the_union(tmp_path):
    t = _trace(tmp_path, EVENTS)
    assert t.window_s == pytest.approx(100e-6)
    summed = sum(i.end - i.start for i in t.device)
    assert summed == pytest.approx(40 + 40 + 20 + 5 + 5)
    # union: 100-105, 110-160, 170-190, 195-200
    assert trace.busy_s(t) == pytest.approx(80e-6)
    assert trace.idle_gaps(t) == [(105, 110), (160, 170), (190, 195)]


def test_summed_time_can_pass_the_window_and_the_union_cannot(tmp_path):
    events = [_x("user_annotation", "w", 0.0, 10.0)] + [
        _x("kernel", f"k{i}", 0.0, 10.0, tid=10 + i) for i in range(3)]
    t = _trace(tmp_path, events)
    assert sum(i.end - i.start for i in t.device) * 1e-6 > t.window_s
    assert trace.busy_s(t) == pytest.approx(t.window_s)


def test_breakdown_and_names(tmp_path):
    t = _trace(tmp_path, EVENTS)
    b = trace.breakdown(t)
    names = dict(b["device_ops"])
    assert names["bspline_dw_mma_kernel"] == pytest.approx(40e-6)
    assert names["walk_tiles_kernel"] == pytest.approx(40e-6)
    assert names["Memcpy DtoD"] == pytest.approx(5e-6)
    idle = dict(b["idle_gaps"])
    # the gap 160-170 is named by what the host ran at its middle (copy_, the
    # launch inside it has ended); the other two by nothing
    assert idle == {"aten::copy_": pytest.approx(10e-6), "host idle": pytest.approx(10e-6)}
    assert trace.group_s(t, ("bspline_", "walk_tiles")) == pytest.approx(80e-6)


def test_no_window_span_is_an_error(tmp_path):
    with pytest.raises(ValueError):
        _trace(tmp_path, [_x("kernel", "k", 0, 1)])
