"""Time the graph paths' input pipeline on the card, one JSON line a path.

G (graph classification gin/kan: 3 convs, hidden 64, one-hot(21) atoms,
native batches) and R (graph regression gin/kan: 4 GINE convs, hidden 64,
OGB encoders, numpy batches), each on random_molecule_graphs(2048, 10, 40,
seed=3) in batches of 256 through `batch_loader`, bf16 over f32 master
weights, Adam(1e-3). In rounds, host clock, each reading an epoch of 8
steps ended by a synchronize, ms per step:

  * alone: the step on one batch already on the card (no loader);
  * sync: fed by the loader without prefetch;
  * prefetch: fed by the loader with prefetch 2, at the interpreter's
    default switch interval and at each of SWITCH_INTERVALS;
  * loader: the prefetching loader alone (no step), ms a batch;
  * alone+hash: the step alone while a second thread burns the CPU
    without the interpreter's lock (sha256 of 1 MiB blocks, which drops
    it): a slowdown is a shortage of cores;
and once: `alone+python`, one step alone while a second thread runs a
Python loop, which holds the lock (the step's every release of the lock
may wait for the loop's next forced switch); host assembly alone and the
prefetch worker's staging of a host batch alone (`staging_ms`; null where
the package has no `stage_batch`), ms a batch; and `cores`: the CPUs the
process may run on and the speedup of two threads hashing at once over
one hashing twice as much.
The host's times vary from round to round on a shared host: each reading
is listed, and its median given.

Run from a tree whose package is to be timed:

    python -m kagnn_tpu_torch.utils.time_graph_loader [--rounds 12]

or, to time another tree's package with this script,
`PYTHONPATH=<tree> python <this file>`.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import statistics
import sys
import threading
import time

import numpy as np
import torch

import kagnn_tpu_torch
from kagnn_tpu_torch.data import random_molecule_graphs
from kagnn_tpu_torch.graphs import batch_graphs, pad_spec_for
from kagnn_tpu_torch.models import GraphClassifier, GraphRegressor
from kagnn_tpu_torch.train import make_graph_cls_steps, make_graph_reg_steps
from kagnn_tpu_torch.train.experiments import batch_loader

BATCH = 256
SWITCH_INTERVALS = (0.0005, 0.05)


def path(task: str):
    """(graphs, train step, native) of path `task`, weights from seed 0."""
    kw = dict(hidden_dim=64, hidden_layers=2, grid_size=4, spline_order=3,
              fused=True, compute_dtype=torch.bfloat16, seed=0, device="cuda")
    if task == "G":
        graphs = random_molecule_graphs(2048, 10, 40, seed=3)
        for g in graphs:
            g["nodes"] = np.eye(21, dtype=np.float32)[g["nodes"][:, 0]]
            g["edges"] = None
        m = GraphClassifier("gin", "kan", gnn_layers=3, num_features=21,
                            num_classes=2, **kw)
        make = make_graph_cls_steps
    else:
        graphs = random_molecule_graphs(2048, 10, 40, seed=3, target="regression")
        m = GraphRegressor("gin", "kan", gnn_layers=4, num_node_features=1,
                           num_edge_features=1, ogb_encoders=True, **kw)
        make = make_graph_reg_steps
    step, _ = make(m, torch.optim.Adam(m.parameters(), lr=1e-3))
    return graphs, step, task == "G"


def staging_ms(host: list, stage_batch) -> float:
    """Host ms a batch of stage_batch(b, "cuda", side stream) over the host
    batches, as in the loader's steady state: each staged batch's copy is
    waited for and released before the next is staged (its pinned block
    reused), the wait outside the time; one warm-up."""
    side, dev = torch.cuda.Stream(), torch.device("cuda")
    total = 0.0
    for i, h in enumerate([host[0], *host]):
        t0 = time.perf_counter()
        item = stage_batch(h, dev, side)
        if i:
            total += time.perf_counter() - t0
        item[1].synchronize()
        del item
    return total * 1e3 / len(host)


_BLOCK = bytes(1 << 20)


def _hash(n: int) -> None:
    for _ in range(n):
        hashlib.sha256(_BLOCK).digest()


def _spin(stop: threading.Event) -> None:
    while not stop.is_set():
        sum(range(1000))


def cores() -> dict:
    """The CPUs this process may run on, and the wall-clock speedup of two
    threads each hashing 64 MiB at once over one thread hashing 128 MiB."""
    t0 = time.perf_counter()
    _hash(128)
    one = time.perf_counter() - t0
    ts = [threading.Thread(target=_hash, args=(64,)) for _ in range(2)]
    t0 = time.perf_counter()
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    return {"affinity": len(os.sched_getaffinity(0)),
            "two_thread_speedup": one / (time.perf_counter() - t0)}


def with_background(target, run):
    """run() while target(stop) runs on a second thread."""
    stop = threading.Event()
    t = threading.Thread(target=target, args=(stop,), daemon=True)
    t.start()
    try:
        return run()
    finally:
        stop.set()
        t.join()


def epoch_ms(run, n: int) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / n


def time_task(task: str, rounds: int) -> dict:
    graphs, step, native = path(task)
    spec = pad_spec_for(graphs, BATCH)
    n = -(-len(graphs) // BATCH)
    loaders = {p: batch_loader(graphs, spec, BATCH, shuffle=True, seed=0,
                               native=native, prefetch=p) for p in (0, 2)}
    for ld in loaders.values():
        for b in ld():
            step(b)
    b0 = next(iter(loaders[0]()))
    default = sys.getswitchinterval()
    out = {"task": task, "package": kagnn_tpu_torch.__file__,
           "card": torch.cuda.get_device_name(0), "alone": [], "sync": [],
           f"prefetch@{default}": [],
           **{f"prefetch@{si}": [] for si in SWITCH_INTERVALS}, "loader": [],
           "alone+hash": []}

    def feed(ld):
        for b in ld():
            step(b)

    for _ in range(rounds):
        out["alone"].append(epoch_ms(lambda: [step(b0) for _ in range(n)], n))
        out["sync"].append(epoch_ms(lambda: feed(loaders[0]), n))
        out[f"prefetch@{default}"].append(epoch_ms(lambda: feed(loaders[2]), n))
        for si in SWITCH_INTERVALS:
            sys.setswitchinterval(si)
            try:
                out[f"prefetch@{si}"].append(epoch_ms(lambda: feed(loaders[2]), n))
            finally:
                sys.setswitchinterval(default)
        out["loader"].append(epoch_ms(lambda: [None for _ in loaders[2]()], n))
        alone = lambda: epoch_ms(lambda: [step(b0) for _ in range(n)], n)  # noqa: E731
        out["alone+hash"].append(with_background(
            lambda stop: [_hash(1) for _ in iter(stop.is_set, True)], alone))
    out["median"] = {k: statistics.median(v) for k, v in out.items()
                     if isinstance(v, list)}
    out["alone+python"] = with_background(_spin, lambda: epoch_ms(lambda: step(b0), 1))
    sels = [np.random.default_rng(i).permutation(len(graphs))[:BATCH] for i in range(n)]
    if native:
        from kagnn_tpu_torch.data.native import NativeBatchAssembler

        nat = NativeBatchAssembler(graphs, spec)
        assemble = lambda s: nat.assemble(s, device="cpu")  # noqa: E731
    else:
        assemble = lambda s: batch_graphs([graphs[j] for j in s], spec, device="cpu")  # noqa: E731
    assemble(sels[0])
    t0 = time.perf_counter()
    host = [assemble(s) for s in sels]
    out["assembly"] = (time.perf_counter() - t0) * 1e3 / n
    try:
        from kagnn_tpu_torch.train.prefetch import stage_batch
    except ImportError:
        out["stage"] = None
    else:
        out["stage"] = staging_ms(host, stage_batch)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=12)
    ap.add_argument("--tasks", default="G,R")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("time_graph_loader: no CUDA device", file=sys.stderr)
        return 1
    print(json.dumps({"cores": cores()}), flush=True)
    for task in args.tasks.split(","):
        print(json.dumps(time_task(task, args.rounds)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
