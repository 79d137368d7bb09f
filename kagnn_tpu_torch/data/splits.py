"""Split-fixture loading, the counterpart of `kagnn_tpu/data/splits.py` —
the Errica-et-al "fair comparison" protocol.

The 10-outer-fold JSON fixtures are the JAX package's, read in place by
file path (`kagnn_tpu/data/fixtures/data_splits/*.json`, copied verbatim
from the reference's `graph_classification/data_splits/`): each fold is
{test: [ids], model_selection: [{train: [ids], validation: [ids]}]}.
"""
from __future__ import annotations

import json
import os

FIXTURE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "kagnn_tpu", "data", "fixtures", "data_splits")


def load_splits(dataset: str, split_dir: str | None = None) -> list[dict]:
    path = os.path.join(split_dir or FIXTURE_DIR, f"{dataset}_splits.json")
    with open(path, "rt") as f:
        for line in f:
            return json.loads(line)
    raise ValueError(f"empty splits file {path}")


def fold_indices(splits: list[dict], fold: int) -> tuple[list, list, list]:
    """(train, val, test) indices of one outer fold."""
    s = splits[fold]
    ms = s["model_selection"][0]
    return ms["train"], ms["validation"], s["test"]
