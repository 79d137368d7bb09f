"""Graph-classification sweep of time to converge and test accuracy, the
counterpart of `experiments/time_graph_model.py` (reference
graph_classification/time_model.py:45-136, broken there): over hidden_dim x
hidden_layers x grid x order, each configuration trained with early
stopping on one random 80/10/10 split of the dataset (the JAX script's),
with its wall-clock seconds, epochs and test accuracy at the best
validation epoch. Appends each row to `--out` as a JSON line and returns
the rows.

    python -m kagnn_tpu_torch.experiments.time_graph_model --dataset MUTAG \\
        --architecture kan --epochs 50

Runs on the card; `KAGNN_PLATFORM=cpu` runs the plain PyTorch path on the
CPU.
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--dataset", default="MUTAG")
    p.add_argument("--architecture", default="kan", choices=["kan", "fastkan", "mlp"])
    p.add_argument("--model_type", default="GIN", choices=["GIN", "GCN", "GAT"])
    p.add_argument("--batch-size", type=int, default=32, dest="batch_size")
    p.add_argument("--epochs", type=int, default=200)
    p.add_argument("--patience", type=int, default=20)
    p.add_argument("--hidden_dims", nargs="+", type=int, default=[16, 64])
    p.add_argument("--hidden_layers", nargs="+", type=int, default=[2])
    p.add_argument("--grids", nargs="+", type=int, default=[4])
    p.add_argument("--orders", nargs="+", type=int, default=[3])
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--random_seed", type=int, default=0)
    p.add_argument("--data_root", default="datasets")
    p.add_argument("--fused", action="store_true",
                   help="use the hand-written CUDA kernels")
    p.add_argument("--out", default="logs/graph_timing.jsonl")
    return p.parse_args(argv)


def split(n: int, seed: int):
    """The JAX script's split: a seeded permutation, 80 % train, 10 %
    validation, 10 % test."""
    idx = np.random.default_rng(seed).permutation(n)
    return idx[:int(0.8 * n)], idx[int(0.8 * n):int(0.9 * n)], idx[int(0.9 * n):]


def main(argv=None) -> list:
    import torch

    from kagnn_tpu_torch.data import load_graph_dataset
    from kagnn_tpu_torch.data.tu import LAYERS_PER_DATASET
    from kagnn_tpu_torch.graphs import pad_spec_for
    from kagnn_tpu_torch.models import GraphClassifier
    from kagnn_tpu_torch.train import make_graph_cls_steps, train_graph_epochs
    from kagnn_tpu_torch.train.experiments import batch_loader
    from kagnn_tpu_torch.utils.platform import platform_device

    args = parse_args(argv)
    device = platform_device()
    graphs = load_graph_dataset(args.dataset, args.data_root)
    tr, va, te = ([graphs[i] for i in part] for part in split(len(graphs), args.random_seed))
    spec = pad_spec_for(graphs, args.batch_size)
    num_features = graphs[0]["nodes"].shape[1]
    num_classes = int(max(int(g["y"][0]) for g in graphs)) + 1

    def loader(part, **kw):
        return batch_loader(part, spec, args.batch_size, device=device, **kw)

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    rows = []
    for hd in args.hidden_dims:
        for hl in args.hidden_layers:
            for grid in (args.grids if args.architecture != "mlp" else [0]):
                for order in (args.orders if args.architecture == "kan" else [0]):
                    model = GraphClassifier(
                        conv_type=args.model_type.lower(), architecture=args.architecture,
                        gnn_layers=LAYERS_PER_DATASET.get(args.dataset, 3),
                        num_features=num_features, hidden_dim=hd,
                        num_classes=num_classes, hidden_layers=hl,
                        grid_size=grid or 4, spline_order=order or 3, dropout=0.0,
                        fused=args.fused, seed=args.random_seed, device=device)
                    opt = torch.optim.Adam(model.parameters(), lr=args.lr)
                    train_step, evaluate = make_graph_cls_steps(model, opt)
                    t0 = time.perf_counter()
                    res = train_graph_epochs(
                        model, train_step, evaluate,
                        loader(tr, shuffle=True, seed=args.random_seed), loader(va),
                        epochs=args.epochs, patience=args.patience,
                        test_batches=loader(te))
                    row = {"arch": args.architecture, "model": args.model_type,
                           "hidden": hd, "hidden_layers": hl, "grid": grid,
                           "order": order,
                           "seconds": round(time.perf_counter() - t0, 2),
                           "epochs_run": res["epochs_run"], "test_acc": res["test_metric"]}
                    rows.append(row)
                    print(json.dumps(row), flush=True)
                    with open(args.out, "a") as f:
                        f.write(json.dumps(row) + "\n")
    return rows


if __name__ == "__main__":
    main()
