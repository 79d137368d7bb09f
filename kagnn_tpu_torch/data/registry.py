"""Dataset registry, the counterpart of `kagnn_tpu/data/registry.py`: one
entry point for every dataset the reference covers, with the JAX registry's
synthetic stand-ins when the raw files are absent (place the raw data under
`data/<Name>/raw` or `datasets/<NAME>` to use the real thing).

The stand-ins copy a quirk of the JAX registry: their seed is
`abs(hash(name)) % 2**31`, and Python's string hash changes from process
to process (PYTHONHASHSEED), so a stand-in's graph does too; within one
process the two registries give the same graph.

Reference registries mirrored here: node task
(node_classification_clean/utils.py:17,30-66), graph classification
(graph_classification_utils.py:10-12,80-91), regression ZINC/QM9
(optuna_zinc.py:140-142, optuna_qm9.py:144-150).
"""
from __future__ import annotations

import warnings

import numpy as np

from kagnn_tpu_torch.data import synthetic
from kagnn_tpu_torch.data.planetoid import (load_geom_gcn, load_ogbn_arxiv,
                                            load_planetoid)
from kagnn_tpu_torch.data.tu import LAYERS_PER_DATASET, load_tu_dataset
from kagnn_tpu_torch.data.zinc import load_qm9, load_zinc

# reference node_classification_clean/utils.py:17
DATASET_LAYERS = {"Cora": 2, "CiteSeer": 2, "Actor": 4, "Texas": 3,
                  "Cornell": 3, "Wisconsin": 3, "ogbn-arxiv": 3}

NODE_DATASETS = tuple(DATASET_LAYERS)
GRAPH_DATASETS = tuple(LAYERS_PER_DATASET)


def load_node_dataset(name: str, root: str = "data",
                      allow_synthetic: bool = True) -> dict:
    """Returns dict(senders, receivers, nodes, y, n_node, {train,val,test}_masks
    (10, n), num_classes)."""
    try:
        if name in ("Cora", "CiteSeer", "PubMed"):
            return load_planetoid(name, root)
        if name in ("Texas", "Cornell", "Wisconsin", "Actor"):
            return load_geom_gcn(name, root)
        if name == "ogbn-arxiv":
            return load_ogbn_arxiv(root)
        raise KeyError(name)
    except (FileNotFoundError, KeyError) as e:
        if not allow_synthetic:
            raise
        warnings.warn(f"dataset {name!r} not on disk ({e}); using a synthetic "
                      f"stand-in with the same task shape")
        big = name == "ogbn-arxiv"
        d = synthetic.community_node_graph(
            n_nodes=10_000 if big else 1_500,
            n_classes=40 if big else 5,
            num_features=128 if big else 32,
            seed=abs(hash(name)) % (2 ** 31))
        masks = d.pop("masks")
        d.update(train_masks=np.repeat(masks["train"][None], 10, 0),
                 val_masks=np.repeat(masks["val"][None], 10, 0),
                 test_masks=np.repeat(masks["test"][None], 10, 0),
                 num_classes=int(d["y"].max()) + 1)
        return d


def load_graph_dataset(name: str, root: str = "datasets",
                       allow_synthetic: bool = True) -> list[dict]:
    use_node_attr = name in ("ENZYMES", "PROTEINS_full")
    try:
        return load_tu_dataset(name, root, use_node_attr=use_node_attr)
    except FileNotFoundError as e:
        if not allow_synthetic:
            raise
        warnings.warn(f"dataset {name!r} not on disk ({e}); using synthetic "
                      f"molecule graphs")
        graphs = synthetic.random_molecule_graphs(
            n_graphs=200, seed=abs(hash(name)) % (2 ** 31),
            target="classification")
        for g in graphs:
            onehot = np.zeros((g["n_node"], 21), np.float32)
            onehot[np.arange(g["n_node"]), g["nodes"][:, 0]] = 1.0
            g["nodes"] = onehot
            g.pop("edges", None)
        return graphs


def load_regression_dataset(name: str, root: str = "datasets",
                            allow_synthetic: bool = True):
    """Returns (train, val, test) lists of graph dicts."""
    try:
        if name.upper() == "ZINC":
            return load_zinc(root)
        if name.upper() == "QM9":
            return load_qm9(root)
        raise KeyError(name)
    except (FileNotFoundError, KeyError) as e:
        if not allow_synthetic:
            raise
        warnings.warn(f"dataset {name!r} not on disk ({e}); using synthetic "
                      f"regression graphs")
        graphs = synthetic.random_molecule_graphs(
            n_graphs=400, seed=7, target="regression")
        return graphs[:300], graphs[300:350], graphs[350:]
