"""Run one cell of the port's benchmark once.

    python3 -m port_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds `BENCHMARK.json`, `port_bench/` and
`kagnn_tpu_torch/`, on a machine with the CUDA cards the cell asks for.

Set-up (counted from process start to the first timed step): the inputs
(the traffic's generator: a graph, its features, labels and training mask)
and weights from `--seed`, the port's model and optimizer with those
weights (the configuration's builder), then the cell's first units of work, which
build and load the kernels, capture a CUDA graph where the traffic captures,
and give the steps the check compares. The window then issues units back to
back for `--seconds`, reading each unit's loss on the host, and ends with a
synchronize. With `--trace 1` a short sub-window after it is profiled.
After the window the program is freed and the plain reference follows the
checked steps from the same weights; the run prints the comparison's
numbers beside their limits as its last lines on standard error (before
them, each phase's seconds and the reference's peak memory), and one JSON
object as the last line of standard output.

Exit codes: 0 with a result; 3 without the cards the cell asks for; 4 when
a module of JAX or of the JAX package was loaded; any other failure raises.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()  # set-up is counted from here, before torch is imported

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import types  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "kagnn_tpu")
WINDOW_SPAN = "port_bench.traced_window"
GIB = 2 ** 30


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name, compared whole, is JAX's or the
    JAX package's (`kagnn_tpu_torch` is the port and is allowed)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


@dataclasses.dataclass
class Window:
    steps: int
    failed: int
    seconds: float
    enqueue_s: float  # host time inside the step entry's calls
    unit_s: list  # each unit's time, call to the host's read of its losses

    @property
    def step_ms(self) -> float:
        return self.seconds * 1e3 / self.steps


def first_units(prog, units: int) -> dict:
    """The program's first `units` units through the window's own call:
    every step's loss, the gradient the optimizer got in the first unit's
    last step, and the parameters after them all."""
    losses, grads = [], None
    for u in range(units):
        losses += prog.unit().tolist()
        if u == 0:
            missing = [k for k, p in prog.params().items() if p.grad is None]
            if missing:
                raise RuntimeError(f"no gradient after the first unit for {missing}")
            grads = {k: p.grad.detach().float().clone() for k, p in prog.params().items()}
    params = {k: p.detach().float().clone() for k, p in prog.params().items()}
    return {"losses": losses, "grads": grads, "params": params}


def timed_window(unit, seconds: float, sync) -> Window:
    sync()
    steps = failed = 0
    enqueue, units = 0.0, []
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        a = time.perf_counter()
        out = unit()
        enqueue += time.perf_counter() - a
        vals = out.tolist()
        units.append(time.perf_counter() - a)
        steps += len(vals)
        failed += sum(not math.isfinite(v) for v in vals)
    sync()
    return Window(steps, failed, time.perf_counter() - t0, enqueue, units)


def traced_window(unit, units: int, cuda: bool, sync):
    """Profile `units` units inside the span WINDOW_SPAN (one unit before it
    absorbs the profiler's start) and read the trace."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from port_bench import trace

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        unit().tolist()
        sync()
        with record_function(WINDOW_SPAN):
            for _ in range(units):
                unit().tolist()
            sync()
    fd, path = tempfile.mkstemp(suffix=".json", prefix="port_bench_trace_")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        del prof
        return trace.load(path, WINDOW_SPAN)
    finally:
        os.remove(path)


def power_limit_w():
    """The card's power limit from nvidia-smi, or None where it cannot say."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits", "-i", "0"],
                             capture_output=True, text=True, timeout=20, check=True)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def main(argv=None, require_chip: bool = True, device: str = "cuda",
         overrides: dict | None = None, program_hook=None) -> int:
    """Run the cell. `require_chip`, `device`, `overrides` ({"graph":
    merged into the traffic's graph, "limits": in place of the cell's}) and
    `program_hook` (called on the built program) serve the tests, which
    drive a run on the CPU at a small size."""
    args = parse(argv)
    from port_bench import check, inputs, manifest, program

    root = manifest.REPO
    bench = manifest.load(root)
    # fixed cache directories inside the checkout, for any build the program
    # makes through PyTorch or Triton (its own CUDA libraries go to
    # kagnn_tpu_torch/_build/, also inside the checkout)
    cache = root / bench["paths"][0] / ".cache"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(cache / sub)
    r = manifest.resolve(bench, args.workload, root)
    config, traffic = r["config"], r["traffic"]
    overrides = overrides or {}
    graph = {**traffic["graph"], **overrides.get("graph", {})}

    import torch

    chips = r["cell"]["chips"]
    if require_chip and (not torch.cuda.is_available() or torch.cuda.device_count() < chips):
        print(f"port_bench: the cell {args.workload} needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    torch.set_num_threads(1)
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(dev)) if cuda else (lambda: None)
    ref = manifest.reference(config)
    phases = {"imports": time.perf_counter() - T0}

    t = time.perf_counter()
    gen = inputs.generator(args.seed, dev)
    data = inputs.make_inputs(graph, args.seed, gen, dev)
    weights = inputs.make_weights(
        ref.param_specs(config, data.num_features, data.num_classes), gen, dev)
    sync()
    phases["inputs"], t = time.perf_counter() - t, time.perf_counter()
    # `peak_mem_gib` is the program's peak from here on: its graph and model,
    # the first units (the warm-up and a CUDA graph's capture, whose pool the
    # replays reuse without a call to the allocator) and the window
    inputs_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    prog = program.build(config, traffic, data, weights, dev)
    if program_hook is not None:
        program_hook(prog)
    sync()
    phases["build"], t = time.perf_counter() - t, time.perf_counter()
    first = first_units(prog, int(traffic["check_units"]))
    sync()
    phases["first_units"] = time.perf_counter() - t
    setup_s = time.perf_counter() - T0

    t = time.perf_counter()
    win = timed_window(prog.unit, args.seconds, sync)
    program_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    phases["window"], t = time.perf_counter() - t, time.perf_counter()
    traced = None
    if args.trace:
        traced = traced_window(prog.unit, int(traffic["trace_units"]), cuda, sync)
        phases["traced"] = time.perf_counter() - t
    unit_steps, steps_checked = prog.unit_steps, len(first["losses"])
    del prog
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)

    t = time.perf_counter()
    rdata = inputs.reference_inputs(ref, data, dev)
    losses, grads, params = ref.train(weights, rdata, config, traffic["optimizer"]["lr"],
                                      steps_checked, unit_steps)
    sync()
    phases["reference"] = time.perf_counter() - t
    reference_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    numbers = check.gaps(first, {"losses": losses, "grads": grads, "params": params}, weights)
    limits = overrides.get("limits", r["limits"]["limits"])
    correct = check.judge(numbers, limits) and win.failed == 0

    device_info = {"platform": "gpu" if cuda else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
                   "count": chips if cuda else 0,
                   "memory_peak_bytes": int(max(inputs_peak, program_peak))}
    metrics, breakdown = {}, None
    if not args.trace:
        values = {"step_ms": win.step_ms, "peak_mem_gib": program_peak / GIB, "setup_s": setup_s}
        units = {m["name"]: m["unit"] for m in r["end_to_end"]}
        metrics = {k: {"value": v, "unit": units[k]} for k, v in values.items() if k in units}
    else:
        from port_bench import trace as tr

        ctx = types.SimpleNamespace(
            trace=traced, steps_traced=int(traffic["trace_units"]) * unit_steps,
            enqueue_s=win.enqueue_s, steps_timed=win.steps, step_ms=win.step_ms,
            config=config, graph=graph)
        for m in r["per_layer"]:
            v = manifest.reader(m["name"], bench, root)(ctx) if cuda else None
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        if cuda:
            device_info.update(busy_s=tr.busy_s(traced), window_s=traced.window_s,
                               power_limit_w=power_limit_w())
            breakdown = tr.breakdown(traced)

    found = forbidden_modules()
    if found:
        print(f"port_bench: loaded {found}, of JAX or the JAX package", file=sys.stderr)
        return 4
    result = {"correct": bool(correct), "attempted": win.steps, "failed": win.failed,
              "metrics": metrics, "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    # a non-finite gap (a NaN loss) is printed as the largest double, so that
    # the line stays JSON
    result["checks"] = {k: {"value": numbers[k] if math.isfinite(numbers[k]) else 1.0e308,
                            "limit": v} for k, v in limits.items()}
    unit_quartiles = ([round(q * 1e3, 4) for q in statistics.quantiles(win.unit_s, n=4)]
                      if len(win.unit_s) > 1 else None)
    print(f"port_bench: phases s {json.dumps({k: round(v, 3) for k, v in phases.items()})} "
          f"(set-up: imports to first_units); reference over {steps_checked} steps, its peak "
          f"{reference_peak / GIB:.4f} GiB with the inputs; window {win.steps} steps "
          f"in {win.seconds:.3f} s (a unit's ms: quartiles {unit_quartiles}, extremes "
          f"{min(win.unit_s) * 1e3:.4f} {max(win.unit_s) * 1e3:.4f}); not compared: "
          f"{ {k: numbers[k] for k in check.NUMBERS if k not in limits} }; worst leaves: grad "
          f"{numbers['grad_leaf']}, change {numbers['change_leaf']}; left out of the change: "
          f"{numbers['still']}",
          file=sys.stderr)
    for k, v in limits.items():
        print(f"check {k} {numbers[k]!r} limit {v!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
