"""Dataset-level feature transforms, the counterparts of
`kagnn_tpu/data/transforms.py` (numpy, verbatim).

Counterparts of the torch_geometric transforms the reference applies:
  * `normalize_features` — PyG `NormalizeFeatures` (row-normalize to sum 1),
    applied to all Planetoid/WebKB/Actor loads
    (node_classification_clean/utils.py:45,51,56);
  * `degree_one_hot` — the reference's `Degree` transform for unlabeled TU
    datasets: one-hot of out-degree clipped to 35 -> 36-dim features
    (graph_classification_utils.py:31-36).
"""
from __future__ import annotations

import numpy as np


def normalize_features(x: np.ndarray) -> np.ndarray:
    s = x.sum(axis=-1, keepdims=True)
    s[s == 0] = 1.0
    return (x / s).astype(np.float32)


def degree_one_hot(senders: np.ndarray, n_node: int,
                   max_degree: int = 35) -> np.ndarray:
    deg = np.bincount(senders, minlength=n_node)
    deg = np.clip(deg, 0, max_degree)
    out = np.zeros((n_node, max_degree + 1), np.float32)
    out[np.arange(n_node), deg] = 1.0
    return out


def to_undirected(senders: np.ndarray, receivers: np.ndarray,
                  deduplicate: bool = True) -> tuple[np.ndarray, np.ndarray]:
    s = np.concatenate([senders, receivers])
    r = np.concatenate([receivers, senders])
    if deduplicate:
        pairs = np.unique(np.stack([s, r], 1), axis=0)
        s, r = pairs[:, 0], pairs[:, 1]
    return s.astype(np.int32), r.astype(np.int32)
