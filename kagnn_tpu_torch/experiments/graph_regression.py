"""Graph-regression HPO driver (ZINC subset and QM9), the counterpart of
`experiments/graph_regression.py` (reference graph_regression/optuna_zinc.py
and optuna_qm9.py, with the JAX driver's defaults: epochs 1000, n_trials
100).

ZINC: official subset splits, L1 loss, the test MAE of the best-validation
model. QM9: the first 12 targets z-score normalized, random 80/10/10 per
seed. `--n_iterations` studies, each seeded `random_seed + iteration`; the
log goes to `logs/<dataset>_<gnn-type>_<model-type>`.

    python -m kagnn_tpu_torch.experiments.graph_regression \\
        --dataset ZINC --gnn-type GIN --model-type KAN

Runs on the card; `KAGNN_PLATFORM=cpu` runs the plain PyTorch path on the
CPU.
"""
from __future__ import annotations

import argparse
import os

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--dataset", default="ZINC", choices=["ZINC", "QM9"])
    p.add_argument("--batch-size", type=int, default=256, dest="batch_size")
    p.add_argument("--epochs", type=int, default=1000)
    p.add_argument("--patience", type=int, default=20)
    p.add_argument("--random_seed", type=int, default=12345)
    p.add_argument("--gnn-type", default="GIN", choices=["GIN", "GCN"],
                   dest="gnn_type")
    p.add_argument("--model-type", default="MLP",
                   choices=["MLP", "KAN", "FASTKAN"], dest="model_type")
    p.add_argument("--num-gnn-layers", type=int, default=4,
                   dest="num_gnn_layers")
    p.add_argument("--n_trials", type=int, default=100)
    p.add_argument("--n_iterations", type=int, default=10)
    p.add_argument("--data_root", default="datasets")
    p.add_argument("--fused", action="store_true")
    p.add_argument("--bf16", action="store_true",
                   help="bf16 mixed-precision compute (f32 master weights)")
    p.add_argument("--loader", default="auto",
                   choices=["auto", "native", "python"],
                   help="batch assembly: C++ assembler or pure python")
    p.add_argument("--prefetch", type=int, default=2,
                   help="batches kept in flight (0 = synchronous)")
    return p.parse_args(argv)


def search_space(trial, arch: str) -> dict:
    """The trial's hyperparameters (reference optuna_zinc.py)."""
    params = {"lr": trial.suggest_float("lr", 1e-4, 1e-2, log=True),
              "hidden_layers": trial.suggest_int("hidden_layers", 1, 4),
              "dropout": trial.suggest_float("dropout", 0.0, 0.9)}
    if arch == "mlp":
        params["hidden_dim"] = trial.suggest_int("hidden_dim", 2, 512)
    else:
        params["hidden_dim"] = trial.suggest_int("hidden_dim", 2, 64)
    if arch == "kan":
        params["grid_size"] = trial.suggest_int("grid_size", 2, 16)
        params["spline_order"] = trial.suggest_int("spline_order", 1, 4)
    elif arch == "fastkan":
        params["grid_size"] = trial.suggest_int("grid_size", 2, 32)
    return params


def main(argv=None) -> dict:
    import torch

    from kagnn_tpu_torch.data import load_regression_dataset
    from kagnn_tpu_torch.graphs import pad_spec_for
    from kagnn_tpu_torch.models import GraphRegressor
    from kagnn_tpu_torch.train import make_graph_reg_steps, train_graph_epochs
    from kagnn_tpu_torch.train.experiments import batch_loader
    from kagnn_tpu_torch.train.hpo import TPESampler, create_study
    from kagnn_tpu_torch.utils.logging import count_params
    from kagnn_tpu_torch.utils.platform import platform_device

    args = parse_args(argv)
    device = platform_device()
    native = {"auto": None, "native": True, "python": False}[args.loader]

    arch = args.model_type.lower()
    if args.dataset == "ZINC":
        train_g, val_g, test_g = load_regression_dataset("ZINC",
                                                         args.data_root)
    else:
        all_g = load_regression_dataset("QM9", args.data_root)
        if isinstance(all_g, tuple):
            all_g = all_g[0] + all_g[1] + all_g[2]
        # reference optuna_qm9.py:144-150: first 12 targets, z-normalized
        ys = np.stack([g["y"][:12] for g in all_g])
        mean, std = ys.mean(0), ys.std(0)
        for g, y in zip(all_g, ys):
            g["y"] = ((y - mean) / std).astype(np.float32)
        rng = np.random.default_rng(args.random_seed)
        idx = rng.permutation(len(all_g))
        n = len(all_g)
        train_g = [all_g[i] for i in idx[:int(0.8 * n)]]
        val_g = [all_g[i] for i in idx[int(0.8 * n):int(0.9 * n)]]
        test_g = [all_g[i] for i in idx[int(0.9 * n):]]

    num_targets = 1 if args.dataset == "ZINC" else 12
    spec = pad_spec_for(train_g + val_g + test_g, args.batch_size)

    def loader(part, **kw):
        return batch_loader(part, spec, args.batch_size, native=native,
                            device=device, **kw)

    def train_with_params(params, with_test):
        model = GraphRegressor(
            conv_type=args.gnn_type.lower(), architecture=arch,
            gnn_layers=args.num_gnn_layers, num_node_features=1,
            num_edge_features=1, hidden_dim=params["hidden_dim"],
            num_targets=num_targets,
            hidden_layers=params.get("hidden_layers", 2),
            grid_size=params.get("grid_size", 4),
            spline_order=params.get("spline_order", 3),
            dropout=params["dropout"],
            ogb_encoders=args.dataset == "ZINC", fused=args.fused,
            compute_dtype=torch.bfloat16 if args.bf16 else None,
            seed=args.random_seed, device=device)
        opt = torch.optim.Adam(model.parameters(), lr=params["lr"])
        train_step, evaluate = make_graph_reg_steps(model, opt)
        res = train_graph_epochs(
            model, train_step, evaluate,
            loader(train_g, shuffle=True, seed=args.random_seed,
                   prefetch=args.prefetch),
            loader(val_g, prefetch=args.prefetch),
            epochs=args.epochs, patience=args.patience,
            test_batches=loader(test_g) if with_test else None,
            classification=False)
        return res, count_params(model)

    def objective(trial):
        res, _ = train_with_params(search_space(trial, arch), with_test=False)
        return res["best_val_loss"]

    os.makedirs("logs", exist_ok=True)
    log_file = os.path.join(
        "logs", f"{args.dataset}_{args.gnn_type}_{args.model_type}")
    test_maes = []
    for it in range(args.n_iterations):
        study = create_study(direction="minimize",
                             sampler=TPESampler(seed=args.random_seed + it))
        study.optimize(objective, n_trials=args.n_trials)
        best = dict(study.best_params)
        res, n_params = train_with_params(best, with_test=True)
        test_maes.append(res["test_metric"])
        with open(log_file, "a") as f:
            f.write(f"iter {it} best {best} test_mae {res['test_metric']} "
                    f"params {n_params}\n")
    summary = {"dataset": args.dataset,
               "test_mae_mean": float(np.mean(test_maes)),
               "test_mae_std": float(np.std(test_maes))}
    with open(log_file, "a") as f:
        f.write(f"FINAL {summary}\n")
    print(summary)
    return summary


if __name__ == "__main__":
    main()
