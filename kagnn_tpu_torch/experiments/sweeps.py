"""The five sweeps of `scripts/*.sh` over the port's drivers:

  run_experiments_kan, run_experiments_fastkan, run_experiments_mlp
      node classification: Cora, CiteSeer, Texas, Cornell, Wisconsin,
      Actor, ogbn-arxiv x gcn, gin, gat for the architecture;
  graph_classification_all
      kan, fastkan, mlp x MUTAG, PROTEINS_full, NCI1, DD, ENZYMES,
      IMDB-BINARY, IMDB-MULTI x GIN, GCN, GAT, each dataset at the reference
      scripts' batch size (MUTAG 32, NCI1 129, the rest 64);
  graph_regression_all
      GIN, GCN x KAN, FASTKAN, MLP x ZINC, QM9.

Each command is one driver's `main(argv)` (`python -m
kagnn_tpu_torch.experiments.<driver> <args>`), run in turn in this process;
arguments after the sweep names go to every command, as the scripts pass
"$@". `--dry_run` prints the commands instead.

    python -m kagnn_tpu_torch.experiments.sweeps run_experiments_kan --dry_run
    python -m kagnn_tpu_torch.experiments.sweeps graph_regression_all --n_trials 5

The drivers run on the card; `KAGNN_PLATFORM=cpu` runs them on the CPU.
"""
from __future__ import annotations

import argparse
import importlib

NODE_DATASETS = ("Cora", "CiteSeer", "Texas", "Cornell", "Wisconsin", "Actor",
                 "ogbn-arxiv")
GRAPH_DATASETS = ("MUTAG", "PROTEINS_full", "NCI1", "DD", "ENZYMES",
                  "IMDB-BINARY", "IMDB-MULTI")
BATCH_SIZE = {"MUTAG": 32, "NCI1": 129, "DD": 64, "PROTEINS_full": 64,
              "ENZYMES": 64, "IMDB-BINARY": 64, "IMDB-MULTI": 64}


def _node(arch):
    return [("node_classification", ["--dataset", d, "--architecture", arch,
                                     "--conv_type", c])
            for d in NODE_DATASETS for c in ("gcn", "gin", "gat")]


SWEEPS = {
    "run_experiments_kan": lambda: _node("kan"),
    "run_experiments_fastkan": lambda: _node("fastkan"),
    "run_experiments_mlp": lambda: _node("mlp"),
    "graph_classification_all": lambda: [
        ("graph_classification", ["--dataset", d, "--model_type", m,
                                  "--architecture", a,
                                  "--batch-size", str(BATCH_SIZE.get(d, 64))])
        for a in ("kan", "fastkan", "mlp") for d in GRAPH_DATASETS
        for m in ("GIN", "GCN", "GAT")],
    "graph_regression_all": lambda: [
        ("graph_regression", ["--dataset", d, "--gnn-type", g, "--model-type", m])
        for g in ("GIN", "GCN") for m in ("KAN", "FASTKAN", "MLP")
        for d in ("ZINC", "QM9")],
}


def commands(name: str, extra=()) -> list[tuple[str, list[str]]]:
    """(driver module, argv) of each command of sweep `name`, in the
    script's order, `extra` appended to each argv."""
    return [(mod, argv + list(extra)) for mod, argv in SWEEPS[name]()]


def main(argv=None) -> list:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("sweeps", nargs="+", choices=sorted(SWEEPS))
    p.add_argument("--dry_run", action="store_true",
                   help="print the commands instead of running them")
    args, extra = p.parse_known_args(argv)
    done = []
    for name in args.sweeps:
        for mod, cmd in commands(name, extra):
            line = " ".join(["python", "-m", f"kagnn_tpu_torch.experiments.{mod}"] + cmd)
            print(line, flush=True)
            if not args.dry_run:
                importlib.import_module(f"kagnn_tpu_torch.experiments.{mod}").main(cmd)
            done.append(line)
    return done


if __name__ == "__main__":
    main()
