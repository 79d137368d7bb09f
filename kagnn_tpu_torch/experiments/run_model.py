"""Single fixed-configuration node-classification run (no HPO), the
counterpart of `experiments/run_model.py` (reference
node_classification_clean/run_model.py, which is broken there): one
`run_node_experiment` over the dataset's splits with the given
hyperparameters; prints and returns its summary.

    python -m kagnn_tpu_torch.experiments.run_model --dataset Cora \\
        --architecture kan --conv_type gcn --hidden_channels 64 --lr 1e-3

Runs on the card; `KAGNN_PLATFORM=cpu` runs the plain PyTorch path on the
CPU.
"""
from __future__ import annotations

import argparse
import json

PARAMS = ("conv_type", "architecture", "hidden_channels", "hidden_layers",
          "grid_size", "spline_order", "lr", "dropout", "epochs", "patience",
          "skip", "heads", "fused", "bf16", "update_grid")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--dataset", default="Cora")
    p.add_argument("--conv_type", default="gcn", choices=["gin", "gcn", "gat"])
    p.add_argument("--architecture", default="kan", choices=["mlp", "kan", "fastkan"])
    p.add_argument("--hidden_channels", type=int, default=64)
    p.add_argument("--hidden_layers", type=int, default=2)
    p.add_argument("--grid_size", type=int, default=4)
    p.add_argument("--spline_order", type=int, default=3)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--dropout", type=float, default=0.0)
    p.add_argument("--epochs", type=int, default=1000)
    p.add_argument("--patience", type=int, default=100)
    p.add_argument("--skip", type=int, default=1)
    p.add_argument("--heads", type=int, default=4)
    p.add_argument("--max_splits", type=int, default=None)
    p.add_argument("--data_root", default="data")
    p.add_argument("--log_dir", default="logs")
    p.add_argument("--fused", action="store_true",
                   help="use the hand-written CUDA kernels")
    p.add_argument("--bf16", action="store_true", help="bf16 mixed-precision compute")
    p.add_argument("--random_seed", type=int, default=0)
    p.add_argument("--update_grid", type=int, default=0,
                   help="refit the KAN grids to the live activations every N "
                        "epochs (reference KAN.forward(update_grid=True), "
                        "ekan.py:270-275); 0 = off")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    from kagnn_tpu_torch.train.experiments import run_node_experiment
    from kagnn_tpu_torch.utils.platform import platform_device

    args = parse_args(argv)
    params = {k: getattr(args, k) for k in PARAMS}
    res = run_node_experiment(params, args.dataset, data_root=args.data_root,
                              log_dir=args.log_dir, max_splits=args.max_splits,
                              seed=args.random_seed, device=platform_device())
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
