"""Seconds an epoch over architectures x widths x grids x orders, the
counterpart of `experiments/time_model.py` (reference
node_classification_clean/time_model.py:35-106: a wall-clock average of
full-batch train steps). Every conv type runs through the same train step
(`train/loops.py::make_node_steps`, Adam 1e-3); one untimed step first
builds the kernels. When the dataset is not on disk it times the
ogbn-arxiv-sized synthetic graph (`data/synthetic.py::arxiv_scale_graph`,
169,343 nodes and 1,166,243 edges, every valid node in the loss). Appends
each row to `--out` as a JSON line and returns the rows.

    python -m kagnn_tpu_torch.experiments.time_model --dataset ogbn-arxiv \\
        --conv gin --architectures kan fastkan mlp --epochs 20

Runs on the card (the host clock around the steps, ending in a
synchronize); `KAGNN_PLATFORM=cpu` times the plain PyTorch path on the CPU.
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--dataset", default="ogbn-arxiv")
    p.add_argument("--conv", default="gin", choices=["gin", "gcn", "gat"])
    p.add_argument("--architectures", nargs="+", default=["mlp", "kan", "fastkan"])
    p.add_argument("--hidden", nargs="+", type=int, default=[64])
    p.add_argument("--grids", nargs="+", type=int, default=[4])
    p.add_argument("--orders", nargs="+", type=int, default=[3])
    p.add_argument("--epochs", type=int, default=20)
    p.add_argument("--data_root", default="data")
    p.add_argument("--fused", action="store_true",
                   help="use the hand-written CUDA kernels")
    p.add_argument("--bf16", action="store_true", help="bf16 mixed-precision compute")
    p.add_argument("--out", default="logs/timing.jsonl")
    return p.parse_args(argv)


def configurations(args):
    """(architecture, hidden, grid, order) of the sweep, as the JAX script
    walks them: an mlp has no grid or order (0), a fastkan no order."""
    for arch in args.architectures:
        for hid in args.hidden:
            for grid in (args.grids if arch != "mlp" else [0]):
                for order in (args.orders if arch == "kan" else [0]):
                    yield arch, hid, grid, order


def load_graph(name: str, root: str) -> dict:
    """The dataset's graph and its first train mask, or the arxiv-sized
    synthetic graph with every node in the loss when it is not on disk."""
    from kagnn_tpu_torch.data import synthetic
    from kagnn_tpu_torch.data.registry import load_node_dataset

    try:
        d = load_node_dataset(name, root, allow_synthetic=False)
        return dict(d, train=d["train_masks"][0])
    except (FileNotFoundError, KeyError):
        d = synthetic.arxiv_scale_graph()
        return dict(d, train=np.ones(d["n_node"], bool),
                    num_classes=int(d["y"].max()) + 1)


def main(argv=None) -> list:
    import torch

    from kagnn_tpu_torch.data.registry import DATASET_LAYERS
    from kagnn_tpu_torch.graphs import single_graph
    from kagnn_tpu_torch.models import NodeClassifier
    from kagnn_tpu_torch.train import make_node_steps
    from kagnn_tpu_torch.utils.platform import platform_device

    args = parse_args(argv)
    device = platform_device()
    d = load_graph(args.dataset, args.data_root)
    g = single_graph(d["senders"], d["receivers"], nodes=d["nodes"], y=d["y"],
                     n_node=int(d["n_node"]), edge_pad_multiple=1024, device=device)
    mask = torch.from_numpy(np.concatenate(
        [d["train"], np.zeros(g.n_node_pad - d["n_node"], bool)])).to(device)
    mp_layers = DATASET_LAYERS.get(args.dataset, 3)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    rows = []
    for arch, hid, grid, order in configurations(args):
        model = NodeClassifier(
            conv_type=args.conv, architecture=arch, mp_layers=mp_layers,
            num_features=d["nodes"].shape[1], hidden_channels=hid,
            num_classes=d["num_classes"], skip=False, grid_size=grid or 4,
            spline_order=order or 3, fused=args.fused,
            compute_dtype=torch.bfloat16 if args.bf16 else None, device=device)
        step, _ = make_node_steps(model, torch.optim.Adam(model.parameters(), lr=1e-3))
        step(g, mask)  # builds the kernels and the optimizer's state
        sync()
        t0 = time.perf_counter()
        for _ in range(args.epochs):
            loss = step(g, mask)
        sync()
        sec = (time.perf_counter() - t0) / args.epochs
        row = {"arch": arch, "conv": args.conv, "hidden": hid, "grid": grid,
               "order": order, "sec_per_epoch": round(sec, 5),
               "edges_per_s": round(g.n_edge / sec, 1), "loss": float(loss),
               "device": (torch.cuda.get_device_name(device)
                          if device.type == "cuda" else "cpu")}
        rows.append(row)
        print(json.dumps(row), flush=True)
        with open(args.out, "a") as f:
            f.write(json.dumps(row) + "\n")
    return rows


if __name__ == "__main__":
    main()
