"""Graph-classification HPO driver (TU datasets, Errica protocol), the
counterpart of `experiments/graph_classification.py` (the reference's
graph_classification/optuna_graph_classification_{kan,fastkan,mlp}.py in
one CLI; search spaces per architecture as the reference's: kan lr
1e-4..1e-2 log, hidden_layers 1..4, hidden_dim 2..64, grid 2..16, order
1..4, dropout 0..0.9; fastkan grid 2..32; mlp hidden_dim 2..512). The
fixture folds of `kagnn_tpu/data/fixtures/data_splits` (random folds for a
dataset without one); the log goes to
`logs/<ARCHITECTURE>_<dataset>_<model_type>`.

    python -m kagnn_tpu_torch.experiments.graph_classification \\
        --dataset MUTAG --model_type GIN --architecture kan

Runs on the card; `KAGNN_PLATFORM=cpu` runs the plain PyTorch path on the
CPU.
"""
from __future__ import annotations

import argparse
import os

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="KAGNN graph classification")
    p.add_argument("--dataset", default="MUTAG")
    p.add_argument("--batch-size", type=int, default=64, dest="batch_size")
    p.add_argument("--epochs", type=int, default=2000)
    p.add_argument("--patience", type=int, default=20)
    p.add_argument("--random_seed", type=int, default=12345)
    p.add_argument("--model_type", default="GIN", choices=["GIN", "GCN", "GAT"])
    p.add_argument("--architecture", default="kan", choices=["kan", "fastkan", "mlp"])
    p.add_argument("--heads", type=int, default=4)
    p.add_argument("--n_trials", type=int, default=100)
    p.add_argument("--n_outer_folds", type=int, default=10)
    p.add_argument("--n_retrains", type=int, default=3,
                   help="retrains of each fold's best configuration (the "
                        "protocol's 3; the JAX driver has no flag for it)")
    p.add_argument("--data_root", default="datasets")
    p.add_argument("--fused", action="store_true")
    p.add_argument("--bf16", action="store_true",
                   help="bf16 mixed-precision compute (f32 master weights)")
    p.add_argument("--loader", default="auto",
                   choices=["auto", "native", "python"],
                   help="batch assembly: C++ assembler (data/native.py) or "
                        "pure python")
    p.add_argument("--prefetch", type=int, default=2,
                   help="batches kept in flight on a background thread "
                        "(0 = synchronous)")
    return p.parse_args(argv)


def search_space(trial, architecture: str) -> dict:
    """The trial's hyperparameters (the reference drivers' :59-68)."""
    params = {"lr": trial.suggest_float("lr", 1e-4, 1e-2, log=True),
              "dropout": trial.suggest_float("dropout", 0.0, 0.9)}
    if architecture == "mlp":
        params["hidden_dim"] = trial.suggest_int("hidden_dim", 2, 512)
        params["hidden_layers"] = trial.suggest_int("hidden_layers", 1, 4)
    elif architecture == "fastkan":
        params["hidden_dim"] = trial.suggest_int("hidden_dim", 2, 64)
        params["hidden_layers"] = trial.suggest_int("hidden_layers", 1, 4)
        params["grid_size"] = trial.suggest_int("grid_size", 2, 32)
    else:
        params["hidden_dim"] = trial.suggest_int("hidden_dim", 2, 64)
        params["hidden_layers"] = trial.suggest_int("hidden_layers", 1, 4)
        params["grid_size"] = trial.suggest_int("grid_size", 2, 16)
        params["spline_order"] = trial.suggest_int("spline_order", 1, 4)
    return params


def random_folds(n_graphs: int, seed: int) -> list[dict]:
    """Ten random outer folds in the fixture's layout (test a tenth; of the
    rest, 90 % train and 10 % validation), for datasets without a fixture."""
    rng = np.random.default_rng(seed)
    idx = rng.permutation(n_graphs)
    k = n_graphs // 10
    splits = []
    for f in range(10):
        test = idx[f * k:(f + 1) * k].tolist()
        rest = np.setdiff1d(idx, test)
        splits.append({"test": test, "model_selection": [{
            "train": rest[:int(0.9 * len(rest))].tolist(),
            "validation": rest[int(0.9 * len(rest)):].tolist()}]})
    return splits


def main(argv=None) -> dict:
    import torch

    from kagnn_tpu_torch.data import (fold_indices, load_graph_dataset,
                                      load_splits)
    from kagnn_tpu_torch.data.tu import LAYERS_PER_DATASET
    from kagnn_tpu_torch.graphs import pad_spec_for
    from kagnn_tpu_torch.models import GraphClassifier
    from kagnn_tpu_torch.train import make_graph_cls_steps, train_graph_epochs
    from kagnn_tpu_torch.train.experiments import (batch_loader,
                                                   graph_classification_protocol)
    from kagnn_tpu_torch.utils.logging import count_params
    from kagnn_tpu_torch.utils.platform import platform_device

    args = parse_args(argv)
    device = platform_device()
    native = {"auto": None, "native": True, "python": False}[args.loader]

    graphs = load_graph_dataset(args.dataset, args.data_root)
    try:
        splits = load_splits(args.dataset)
    except FileNotFoundError:
        splits = random_folds(len(graphs), args.random_seed)

    spec = pad_spec_for(graphs, args.batch_size)
    num_features = graphs[0]["nodes"].shape[1]
    num_classes = int(max(int(g["y"][0]) for g in graphs)) + 1
    gnn_layers = LAYERS_PER_DATASET.get(args.dataset, 3)

    def loader(part, **kw):
        return batch_loader(part, spec, args.batch_size, native=native,
                            device=device, **kw)

    def build_and_train(params, fold, with_test):
        tr_idx, va_idx, te_idx = fold_indices(splits, fold)
        tr = [graphs[i] for i in tr_idx]
        va = [graphs[i] for i in va_idx]
        te = [graphs[i] for i in te_idx]
        model = GraphClassifier(
            conv_type=args.model_type.lower(),
            architecture=args.architecture,
            gnn_layers=gnn_layers, num_features=num_features,
            hidden_dim=params["hidden_dim"], num_classes=num_classes,
            hidden_layers=params.get("hidden_layers", 2),
            grid_size=params.get("grid_size", 4),
            spline_order=params.get("spline_order", 3),
            dropout=params["dropout"], heads=args.heads, fused=args.fused,
            compute_dtype=torch.bfloat16 if args.bf16 else None,
            seed=args.random_seed, device=device)
        opt = torch.optim.Adam(model.parameters(), lr=params["lr"])
        train_step, evaluate = make_graph_cls_steps(model, opt)
        res = train_graph_epochs(
            model, train_step, evaluate,
            loader(tr, shuffle=True, seed=args.random_seed,
                   prefetch=args.prefetch),
            loader(va, prefetch=args.prefetch),
            epochs=args.epochs, patience=args.patience,
            test_batches=loader(te) if with_test else None)
        return res, count_params(model)

    def trainer(params, fold):
        res, n_params = build_and_train(params, fold, with_test=True)
        return res["test_metric"], n_params

    def objective(trial, fold):
        params = search_space(trial, args.architecture)
        res, _ = build_and_train(params, fold, with_test=False)
        return res["best_val_loss"]

    log_file = os.path.join(
        "logs", f"{args.architecture.upper()}_{args.dataset}_{args.model_type}")
    result = graph_classification_protocol(
        args.dataset, trainer, objective, log_file,
        n_outer_folds=args.n_outer_folds, n_trials=args.n_trials,
        n_retrains=args.n_retrains, seed=args.random_seed)
    print(result)
    return result


if __name__ == "__main__":
    main()
