"""The per-layer metrics read from the program's spans, on synthetic traces:
each reads its spans on the traced thread, clipped to the window, a step; a
program that records no span of its own (the parent of the spans) gives
nothing; a captured cell's replay gives 0 host ms to the eager phases."""
import json
import types

import pytest

from port_bench import manifest, trace

BENCH = manifest.load()
NAMES = ["host_ms.step", "host_ms.forward", "host_ms.backward", "host_ms.optimizer",
         "device_idle_ms.in_step"]


def _x(cat, name, ts, dur, tid=1):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid, "pid": 1}


def _ctx(tmp_path, events, steps):
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": [_x("user_annotation", "w", 100, 200)] + events}))
    return types.SimpleNamespace(trace=trace.load(str(path), "w"), steps_traced=steps)


def _read(name, ctx):
    return manifest.reader(name, BENCH)(ctx)


# two eager steps, the first begun before the window; the optimizer's
# zero_grad of the first before it; another thread's step, not read
EAGER = [
    _x("user_annotation", "kagnn.step", 90, 60),
    _x("user_annotation", "Optimizer.zero_grad#Adam.zero_grad", 92, 2),
    _x("user_annotation", "kagnn.step.forward", 95, 25),
    _x("user_annotation", "kagnn.kan_layer", 100, 10),
    _x("user_annotation", "kagnn.step.backward", 125, 20),
    _x("user_annotation", "Optimizer.step#Adam.step", 146, 3),
    _x("user_annotation", "kagnn.step", 160, 100),
    _x("user_annotation", "Optimizer.zero_grad#Adam.zero_grad", 161, 2),
    _x("user_annotation", "kagnn.step.forward", 165, 35),
    _x("user_annotation", "kagnn.step.backward", 205, 45),
    _x("user_annotation", "Optimizer.step#Adam.step", 252, 6),
    _x("user_annotation", "kagnn.step", 100, 200, tid=2),
    _x("kernel", "bspline_fwd_mma_kernel", 100, 30, 7),
    _x("kernel", "vectorized_elementwise_kernel", 140, 30, 7),
    _x("kernel", "bspline_dw_mma_kernel", 200, 40, 7),
    _x("kernel", "Memcpy DtoH", 280, 10, 7),
]


def test_eager_step_phases_a_step(tmp_path):
    ctx = _ctx(tmp_path, EAGER, 2)
    got = {n: _read(n, ctx) for n in NAMES}
    assert got["host_ms.step"] == pytest.approx((50 + 100) * 1e-3 / 2)
    assert got["host_ms.forward"] == pytest.approx((20 + 35) * 1e-3 / 2)
    assert got["host_ms.backward"] == pytest.approx((20 + 45) * 1e-3 / 2)
    assert got["host_ms.optimizer"] == pytest.approx((3 + 2 + 6) * 1e-3 / 2)
    # idle 130-140, 170-200, 240-280, 290-300; inside the steps 10 + 30 + 20
    assert got["device_idle_ms.in_step"] == pytest.approx(60 * 1e-3 / 2)
    assert (got["host_ms.forward"] + got["host_ms.backward"] + got["host_ms.optimizer"]
            <= got["host_ms.step"])
    idle_ms = sum(b - a for a, b in trace.idle_gaps(ctx.trace)) * 1e-3 / 2
    assert got["device_idle_ms.in_step"] <= idle_ms


def test_captured_cell_has_steps_and_no_eager_phases(tmp_path):
    events = []
    for t in (100, 200):
        events += [_x("user_annotation", "kagnn.multi_step", t, 50),
                   _x("user_annotation", "kagnn.multi_step.copy_in", t + 2, 10),
                   _x("user_annotation", "kagnn.multi_step.replay", t + 14, 30),
                   _x("kernel", "gin_fwd_mma_kernel", t + 20, 70, 7)]
    ctx = _ctx(tmp_path, events, 20)
    got = {n: _read(n, ctx) for n in NAMES}
    assert got["host_ms.step"] == pytest.approx(100 * 1e-3 / 20)
    assert got["host_ms.forward"] == got["host_ms.backward"] == got["host_ms.optimizer"] == 0
    # idle 100-120 and 190-220 inside the calls (20 + 20 µs), 290-300 outside
    assert got["device_idle_ms.in_step"] == pytest.approx(40 * 1e-3 / 20)


@pytest.mark.parametrize("name", NAMES)
def test_a_program_without_spans_reports_nothing(tmp_path, name):
    """The parent's trace: torch's optimizer spans, no span of the program."""
    events = [e for e in EAGER if not e["name"].startswith("kagnn.")]
    assert _read(name, _ctx(tmp_path, events, 2)) is None


def test_span_report_drives_a_cell_on_the_cpu(capsys, tiny):
    """`port_bench.spans` on the CPU at a small size: the eager cell's step
    splits into its phases, each read a step, and nothing of the device."""
    from port_bench import spans

    rc = spans.main(["--workload", "kagat.arxiv-eager", "--seed", "4000000017",
                     "--seconds", "0.1", "--units", "1"], device="cpu", graph=tiny)
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and result["device"] == "cpu" and result["steps_profiled"] == 1
    ph = result["phases"]
    assert list(ph) == ["forward", "backward", "optimizer", "step, rest", "outside spans",
                        "phases, added"]
    assert ph["forward"]["host_ms"] > 0 and ph["backward"]["host_ms"] > 0
    assert result["spans"]["kagnn.step"]["count"] == 1
    assert result["spans"]["(all)"]["device_ms"] == 0
