"""Partition scaling harness, the counterpart of `experiments/scaling.py`:
edges/s of the halo-exchange node partition (dist/halo.py) or the edge
partition with all-reduce (dist/partition.py) at several rank counts.

    python -m kagnn_tpu_torch.experiments.scaling --devices 1 2 4 \\
        --strategy halo --backend nccl

Each count runs as that many ranks (dist/launch.py) of `--backend`: "nccl"
takes one card a rank (a count above the cards present raises before the
first run); "gloo" runs on the CPU (`--device cpu`) or puts every rank on
one card, where the times measure the partition's cost and not its
scaling. One JSON row a count,
the JAX report's keys (plus the rank's last loss).
"""
from __future__ import annotations

import argparse
import functools
import json


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--devices", nargs="+", type=int, default=[1, 2, 4, 8])
    p.add_argument("--n_nodes", type=int, default=20000)
    p.add_argument("--n_edges", type=int, default=200000)
    p.add_argument("--hidden", type=int, default=64)
    p.add_argument("--architecture", default="kan",
                   choices=["mlp", "kan", "fastkan"])
    p.add_argument("--conv", default="gin", choices=["gin", "gcn", "gat"])
    p.add_argument("--iters", type=int, default=5)
    p.add_argument("--fused", action="store_true")
    p.add_argument("--strategy", default="halo",
                   choices=["halo", "allreduce"],
                   help="halo: node shards + boundary-only all_to_all "
                        "(dist/halo.py); allreduce: replicated nodes + "
                        "all-reduced segment sums (dist/partition.py)")
    p.add_argument("--reorder", default="none",
                   choices=["none", "rcm", "degree"],
                   help="renumber nodes before partitioning (shrinks the "
                        "halo boundary)")
    p.add_argument("--backend", default="nccl", choices=["nccl", "gloo"],
                   help="nccl: one card a rank; gloo: the CPU, or several "
                        "ranks on one card")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return p.parse_args(argv)


def model_fn(args: dict):
    """One rank's (model, optimizer, graph, mask): the JAX harness's
    synthetic graph (64 features, 10 classes), 3 convs, Adam(1e-3), on the
    rank's device."""
    import numpy as np
    import torch

    from kagnn_tpu_torch.data.synthetic import arxiv_scale_graph
    from kagnn_tpu_torch.graphs import single_graph
    from kagnn_tpu_torch.models import NodeClassifier

    device = torch.device(args["device"])
    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    d = arxiv_scale_graph(n_nodes=args["n_nodes"], n_edges=args["n_edges"],
                          num_features=64, n_classes=10)
    if args["reorder"] != "none":
        from kagnn_tpu_torch.graphs.reorder import (bfs_order, degree_order,
                                                    reorder_graph)
        d = reorder_graph(d, {"rcm": bfs_order, "degree": degree_order}[args["reorder"]])
    g = single_graph(d["senders"], d["receivers"], nodes=d["nodes"], y=d["y"],
                     edge_pad_multiple=1024, device=device)
    mask = torch.from_numpy(np.arange(g.n_node_pad) < int(d["n_node"])).to(device)
    model = NodeClassifier(conv_type=args["conv"], architecture=args["architecture"],
                           mp_layers=3, num_features=64,
                           hidden_channels=args["hidden"], num_classes=10,
                           skip=False, fused=args["fused"], device=device)
    return model, torch.optim.Adam(model.parameters(), lr=1e-3), g, mask


def main(argv=None) -> list:
    from kagnn_tpu_torch.dist.halo import halo_scaling_report
    from kagnn_tpu_torch.dist.partition import scaling_report

    args = parse_args(argv)
    report = halo_scaling_report if args.strategy == "halo" else scaling_report
    rows = report(functools.partial(model_fn, vars(args)),
                  n_devices_list=args.devices, iters=args.iters,
                  backend=args.backend, device=args.device)
    for r in rows:
        print(json.dumps(r))
    return rows


if __name__ == "__main__":
    main()
