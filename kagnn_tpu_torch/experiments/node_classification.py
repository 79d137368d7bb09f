"""Node-classification HPO driver, the counterpart of
`experiments/node_classification.py` (reference
node_classification_clean/one_experiment.py): an HPO study over the same
search space (lr log-uniform 1e-5..1e-2, dropout 0..0.9, hidden width per
architecture, grid size / spline order for the KAN variants, GIN update-net
depth), minimizing mean val loss across splits, followed by 3 repeated
final evaluations of the best configuration, appended to
`<log_dir>/<dataset>_<architecture>_<conv_type>_finished`.

    python -m kagnn_tpu_torch.experiments.node_classification \\
        --dataset Cora --architecture kan --conv_type gcn --n_trials 100

Runs on the card; `KAGNN_PLATFORM=cpu` runs the plain PyTorch path on the
CPU.
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Node_classif")
    p.add_argument("--dataset", default="Cora")
    p.add_argument("--epochs", type=int, default=10000)
    p.add_argument("--patience", type=int, default=100)
    p.add_argument("--random_seed", type=int, default=12345)
    p.add_argument("--conv_type", default="gat", choices=["gin", "gcn", "gat"])
    p.add_argument("--architecture", default="mlp", choices=["mlp", "kan", "fastkan"])
    p.add_argument("--skip", type=int, default=1)
    p.add_argument("--heads", type=int, default=4)
    p.add_argument("--n_trials", type=int, default=100)
    p.add_argument("--max_splits", type=int, default=None)
    p.add_argument("--data_root", default="data")
    p.add_argument("--log_dir", default="logs")
    p.add_argument("--fused", action="store_true",
                   help="use the hand-written CUDA kernels")
    p.add_argument("--bf16", action="store_true",
                   help="bf16 mixed-precision compute")
    p.add_argument("--reorder", default="none",
                   choices=["none", "rcm", "degree"],
                   help="renumber nodes for gather locality "
                        "(graphs/reorder.py)")
    p.add_argument("--sampling", default=None,
                   help="comma-separated per-hop fanouts, e.g. 10,5 — train "
                        "on GraphSAGE-style sampled mini-batches instead of "
                        "full batch (for ogbn-arxiv scale)")
    p.add_argument("--sampling_batch", type=int, default=512,
                   help="seed-node batch size when --sampling is set")
    return p.parse_args(argv)


def base_params(args) -> dict:
    fanouts = ([int(f) for f in args.sampling.split(",")]
               if args.sampling else None)
    return {
        "dataset": args.dataset, "conv_type": args.conv_type,
        "architecture": args.architecture, "patience": args.patience,
        "epochs": args.epochs, "skip": args.skip, "heads": args.heads,
        "fused": args.fused, "bf16": args.bf16, "reorder": args.reorder,
        "sampling": fanouts, "sampling_batch": args.sampling_batch,
        "hidden_layers": 0, "grid_size": 0, "spline_order": 0,
    }


def search_space(trial, conv_type: str, architecture: str) -> dict:
    """The trial's hyperparameters (reference one_experiment.py:34-46)."""
    params = {"lr": trial.suggest_float("lr", 1e-5, 1e-2, log=True),
              "dropout": trial.suggest_float("dropout", 0, 0.9)}
    if conv_type == "gin":
        params["hidden_layers"] = trial.suggest_int("hidden_layers", 1, 4)
    if architecture == "mlp":
        params["hidden_channels"] = trial.suggest_int("hidden_channels", 1, 256)
    elif architecture == "fastkan":
        params["hidden_channels"] = trial.suggest_int("hidden_channels", 2, 128)
        params["grid_size"] = trial.suggest_int("grid_size", 2, 32)
    elif architecture == "kan":
        params["hidden_channels"] = trial.suggest_int("hidden_channels", 2, 128)
        params["grid_size"] = trial.suggest_int("grid_size", 1, 8)
        params["spline_order"] = trial.suggest_int("spline_order", 1, 3)
    return params


def main(argv=None) -> dict:
    from kagnn_tpu_torch.train.experiments import run_node_experiment
    from kagnn_tpu_torch.train.hpo import TPESampler, create_study
    from kagnn_tpu_torch.utils.platform import platform_device

    args = parse_args(argv)
    device = platform_device()

    def run(params, seed):
        return run_node_experiment(params, args.dataset,
                                   data_root=args.data_root,
                                   log_dir=args.log_dir,
                                   max_splits=args.max_splits, seed=seed,
                                   device=device)

    def objective(trial):
        params = base_params(args)
        params.update(search_space(trial, args.conv_type, args.architecture))
        res = run(params, args.random_seed)
        trial.params_full = params
        return res["val_loss_mean"]

    study = create_study(direction="minimize",
                         sampler=TPESampler(seed=args.random_seed))
    study.optimize(objective, n_trials=args.n_trials)

    # 3 repeated final evaluations (reference one_experiment.py:68-77)
    best = study.best_params
    params = base_params(args)
    params.update(best)
    accs = []
    for rep in range(3):
        accs.extend(run(params, args.random_seed + rep)["test_accs"])
    os.makedirs(args.log_dir, exist_ok=True)
    out = {"mean": float(np.mean(accs)), "std": float(np.std(accs, ddof=1)),
           "best_params": best}
    with open(os.path.join(
            args.log_dir,
            f"{args.dataset}_{args.architecture}_{args.conv_type}_finished"),
            "a") as f:
        f.write(json.dumps(out) + "\n")
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
