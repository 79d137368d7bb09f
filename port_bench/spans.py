"""Host and device ms by the program's spans for one cell: an operator's
report, not a metric of the benchmark.

    python3 -m port_bench.spans --workload <cell> --seed <n> [--seconds 10] [--units k]

On a machine with a CUDA card, from the root of a checkout. Builds the
cell's program as `port_bench.run` does, runs its first units and an
untraced window of `--seconds` (its `step_ms`), then profiles `--units`
units (the traffic's `trace_units` by default) with
`kagnn_tpu_torch.utils.profiling.trace` and reads the trace with
`profiling.span_report`: host and device ms a step by span, and the same
for PyTorch's own kernels (those outside the port's kernel families), and
the host events the profiler recorded a step (on every thread). Also times
`profiling.span` alone with the profiler off and on. Prints one JSON
object as its last line of standard output and a table before it.
"""
from __future__ import annotations

import argparse
import json
import runpy
import sys
import tempfile
import time
import timeit
from pathlib import Path


def span_cost_us(n_off: int = 1_000_000, n_on: int = 20_000) -> dict:
    """µs an enter and exit of `profiling.span` costs with no profiler
    running and inside a running profiler (the best of 5 repeats each)."""
    import torch

    from kagnn_tpu_torch.utils import profiling

    def spanned():
        with profiling.span(profiling.STEP):
            pass

    off = min(timeit.repeat(spanned, number=n_off, repeat=5)) / n_off * 1e6
    with torch.profiler.profile(activities=profiling._activities()):
        on = min(timeit.repeat(spanned, number=n_on, repeat=5)) / n_on * 1e6
    return {"off_us": off, "on_us": on}


def per_step(report: dict, steps: int) -> dict:
    """span_report's rows a step."""
    return {name: {k: v / steps for k, v in row.items()} for name, row in report.items()}


def phases(report: dict) -> dict:
    """Host and device ms of the step's phases, from span_report's rows:
    an eager step's forward, backward, optimizer and the rest of the step;
    the multi-step entry's capture, copy-in, replay and the rest of the
    call; the device work outside every span (the caller's); the phases'
    device ms added up."""
    from kagnn_tpu_torch.utils import profiling as p

    keys = ("host_ms", "device_ms", "summed_device_ms")

    def total(names):
        rows = [report[n] for n in names if n in report]
        return {k: sum(r[k] for r in rows) for k in keys}

    def rest(outer, parts):
        inner = total(parts)
        return {**{k: report[outer][k] - inner[k] for k in keys},
                "device_ms": report[outer]["self_device_ms"]}

    out = {}
    if p.STEP in report:
        optimizer = [n for n in report if n.startswith(p.OPTIMIZER_SPANS)]
        out = {"forward": total([p.STEP_FORWARD]), "backward": total([p.STEP_BACKWARD]),
               "optimizer": total(optimizer),
               "step, rest": rest(p.STEP, [p.STEP_FORWARD, p.STEP_BACKWARD] + optimizer)}
    if p.MULTI_STEP in report:
        parts = [p.MULTI_STEP_CAPTURE, p.MULTI_STEP_COPY_IN, p.MULTI_STEP_REPLAY]
        out.update({n.rsplit(".", 1)[1]: total([n]) for n in parts})
        out["multi_step, rest"] = rest(p.MULTI_STEP, parts)
    out["outside spans"] = {**report[p.OUTSIDE], "host_ms": None}
    out["phases, added"] = {"host_ms": None, **{k: sum(r[k] for r in out.values())
                                               for k in keys[1:]}}
    return out


def main(argv=None, device: str = "cuda", graph: dict | None = None) -> int:
    """Run the report. `device` and `graph` (merged into the traffic's)
    serve the tests, which drive it on the CPU at a small size."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--units", type=int, default=0, help="0: the traffic's trace_units")
    args = ap.parse_args(argv)

    import torch

    from port_bench import inputs, manifest, program, run, trace
    from kagnn_tpu_torch.utils import profiling

    dev = torch.device(device)
    cuda = dev.type == "cuda"
    if cuda and not torch.cuda.is_available():
        print("port_bench.spans: needs a CUDA card", file=sys.stderr)
        return 3
    torch.set_num_threads(1)
    r = manifest.resolve(manifest.load(), args.workload)
    config, traffic = r["config"], r["traffic"]
    sync = (lambda: torch.cuda.synchronize(dev)) if cuda else (lambda: None)
    ref = manifest.reference(config)
    gen = inputs.generator(args.seed, dev)
    data = inputs.make_inputs({**traffic["graph"], **(graph or {})}, args.seed, gen, dev)
    weights = inputs.make_weights(
        ref.param_specs(config, data.num_features, data.num_classes), gen, dev)
    prog = program.build(config, traffic, data, weights, dev)
    run.first_units(prog, int(traffic["check_units"]))
    win = run.timed_window(prog.unit, args.seconds, sync)

    units = args.units or int(traffic["trace_units"])
    steps = units * prog.unit_steps
    port = runpy.run_path(str(manifest.HERE / "metrics" / "device_ms.torch_ops.py"))
    torch_op = lambda name: not trace.base_name(name).startswith(port["PORT_KERNELS"])  # noqa: E731
    prog.unit().tolist()
    sync()
    with tempfile.TemporaryDirectory() as tmp:
        with profiling.trace(tmp):
            t0 = time.perf_counter()
            for _ in range(units):
                prog.unit().tolist()
            sync()
            profiled_s = time.perf_counter() - t0
        path = str(Path(tmp) / "trace.json")
        report = per_step(profiling.span_report(path), steps)
        torch_ops = per_step(profiling.span_report(path, keep=torch_op), steps)
        with open(path) as f:
            host_events = sum(e.get("ph") == "X" and e.get("cat") in trace.HOST_CATS
                              for e in json.load(f).get("traceEvents", []))
    n_spans = sum(row["count"] for name, row in report.items()
                  if name not in (profiling.OUTSIDE, profiling.ALL))
    result = {
        "workload": args.workload, "seed": args.seed,
        "device": torch.cuda.get_device_name(dev) if cuda else "cpu",
        "power_limit_w": run.power_limit_w() if cuda else None,
        "step_ms_untraced": win.step_ms, "step_ms_profiled": profiled_s * 1e3 / steps,
        "host_enqueue_ms_untraced": win.enqueue_s * 1e3 / win.steps,
        "steps_profiled": steps, "spans_a_step": n_spans,
        "host_events_a_step": host_events / steps,
        "span_cost_us": span_cost_us() if cuda else None,
        "phases": phases(report), "torch_ops_phases": phases(torch_ops),
        "spans": report, "torch_ops_spans": torch_ops,
    }
    print(f"{args.workload} on {result['device']} ({result['power_limit_w']} W): step_ms "
          f"untraced {win.step_ms:.4f}, profiled {result['step_ms_profiled']:.4f}; untraced "
          f"host enqueue {result['host_enqueue_ms_untraced']:.4f} ms a step; {n_spans:g} spans "
          f"and {host_events / steps:g} host events a step; span {result['span_cost_us']}")
    print(f"{'ms a step':34s} {'host':>9s} {'device':>9s} {'summed':>9s} {'torch ops':>9s}")
    for name, row in list(result["phases"].items()) + list(report.items()):
        host = "" if row["host_ms"] is None else f"{row['host_ms']:.4f}"
        torch_row = result["torch_ops_phases"].get(name) or torch_ops[name]
        print(f"{name:34s} {host:>9s} {row['device_ms']:9.4f} {row['summed_device_ms']:9.4f} "
              f"{torch_row['device_ms']:9.4f}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
