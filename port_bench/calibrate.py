"""The readings the correctness limits of `cells/<cell>.json` are set from,
at the cell's own size, many seeds in one process (no measured window: a
training cell's numbers need none).

    python3 -m port_bench.calibrate --workload <cell> --seeds 11 12 13 [--kinds ...]

For each seed, each number of `check.py` for:
  * `program`: the port's first units, driven as a run drives them, against
    the float32 reference (the lower reading);
  * `control_fp8`: the reference computed in float8 e4m3 (the precision
    below the configuration's bf16) in the program's place;
  * `half_batch`: the reference with the loss's mean taken over half of the
    training nodes in the program's place (a fault the check must catch).
A step that leaves the state unchanged reads 1 on `change_gap` and needs no
run. One JSON object a seed goes to standard output.
"""
from __future__ import annotations

import argparse
import gc
import importlib
import json
import sys
import time

import torch

from port_bench import check, inputs, manifest, program, run

KINDS = ("program", "control_fp8", "half_batch")


def half_mask(mask: torch.Tensor) -> torch.Tensor:
    """The first half of the training nodes, by index."""
    return mask & (torch.cumsum(mask.long(), 0) <= int(mask.sum()) // 2)


def readings(resolved: dict, seed: int, device, kinds=KINDS, graph=None) -> dict:
    """{kind: check.gaps(...)} for one seed."""
    config, traffic = resolved["config"], resolved["traffic"]
    graph = graph or traffic["graph"]
    ref = importlib.import_module(f"port_bench.reference.{config['reference']}")
    gen = inputs.generator(seed, device)
    data = inputs.make_graph(graph, seed, gen, device)
    weights = inputs.make_weights(
        ref.param_specs(config, data.num_features, data.num_classes), gen, device)
    units, unit_steps = int(traffic["check_units"]), int(traffic["unit_steps"])
    out = {}
    if "program" in kinds:
        prog = program.build(config, traffic, data, weights, device)
        first = run.first_units(prog, units)
        del prog
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
    rdata = {"senders": torch.from_numpy(data.senders).long().to(device),
             "receivers": torch.from_numpy(data.receivers).long().to(device),
             "nodes": data.nodes, "labels": data.labels, "train_mask": data.train_mask}
    lr, steps = traffic["optimizer"]["lr"], units * unit_steps

    def side(**kw):
        losses, grads, params = ref.train(weights, rdata, config, lr, steps, unit_steps, **kw)
        return {"losses": losses, "grads": grads, "params": params}

    truth = side()
    others = {"program": lambda: first,
              "control_fp8": lambda: side(rounding=ref.rounding_to(torch.float8_e4m3fn)),
              "half_batch": lambda: side(loss_mask=half_mask(data.train_mask))}
    for kind in kinds:
        g = check.gaps(others[kind](), truth, weights)
        out[kind] = {k: g[k] for k in (*check.NUMBERS, "grad_leaf", "change_leaf")}
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--kinds", nargs="+", default=list(KINDS), choices=KINDS)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("port_bench.calibrate reads on the card and found none", file=sys.stderr)
        return 3
    resolved = manifest.resolve(manifest.load(), args.workload)
    dev = torch.device("cuda")
    for seed in args.seeds:
        t = time.perf_counter()
        out = readings(resolved, seed, dev, args.kinds)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "seconds": time.perf_counter() - t, **out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
