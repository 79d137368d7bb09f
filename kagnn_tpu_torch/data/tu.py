"""TU-dataset (graph classification) raw-format parser, the counterpart
of `kagnn_tpu/data/tu.py` (numpy, verbatim).

Reads the standard TU text format (DS_A.txt edge list, DS_graph_indicator.txt,
DS_graph_labels.txt, optional DS_node_labels.txt / DS_node_attributes.txt)
that TUDataset downloads unpack to — the same underlying data the reference
loads through `torch_geometric.datasets.TUDataset`
(graph_classification_utils.py:80-91). Returns a list of graph dicts
compatible with `kagnn_tpu_torch.graphs.batch_graphs`.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np

from kagnn_tpu_torch.data.transforms import degree_one_hot

# reference graph_classification_utils.py:10-12
UNLABELED_DATASETS = ("IMDB-BINARY", "IMDB-MULTI", "REDDIT-BINARY",
                      "REDDIT-MULTI-5K", "COLLAB")
LAYERS_PER_DATASET = {"IMDB-BINARY": 2, "IMDB-MULTI": 2, "MUTAG": 2,
                      "PROTEINS_full": 2, "DD": 3, "ENZYMES": 4, "NCI1": 5}


def _find_raw_dir(root: str, name: str) -> Optional[str]:
    for cand in (os.path.join(root, name, name, "raw"),
                 os.path.join(root, name, "raw"),
                 os.path.join(root, name),
                 root):
        if os.path.exists(os.path.join(cand, f"{name}_A.txt")):
            return cand
    return None


def load_tu_dataset(name: str, root: str = "datasets",
                    use_node_attr: bool = False) -> list[dict]:
    """Parse a TU dataset into per-graph dicts with one-hot label features
    (+ optional continuous attributes) and integer y.

    use_node_attr mirrors the reference's flag (True for ENZYMES /
    PROTEINS_full, graph_classification_utils.py:81-83).
    """
    raw = _find_raw_dir(root, name)
    if raw is None:
        raise FileNotFoundError(
            f"TU dataset {name!r} not found under {root!r} "
            f"(expected {name}_A.txt in a raw/ dir)")

    def path(suffix):
        return os.path.join(raw, f"{name}_{suffix}.txt")

    edges = np.loadtxt(path("A"), delimiter=",", dtype=np.int64,
                       ndmin=2) - 1  # 1-based ids
    graph_of_node = np.loadtxt(path("graph_indicator"), dtype=np.int64,
                               ndmin=1) - 1
    graph_labels = np.loadtxt(path("graph_labels"), dtype=np.int64, ndmin=1)
    # remap labels to 0..C-1 preserving sort order (PyG does the same)
    uniq = np.unique(graph_labels)
    y_all = np.searchsorted(uniq, graph_labels).astype(np.int32)

    n_nodes_total = graph_of_node.shape[0]
    node_labels = None
    if os.path.exists(path("node_labels")):
        node_labels = np.loadtxt(path("node_labels"), dtype=np.int64, ndmin=1)
        uniq_nl = np.unique(node_labels)
        node_labels = np.searchsorted(uniq_nl, node_labels)
        n_label_classes = len(uniq_nl)
    node_attrs = None
    if use_node_attr and os.path.exists(path("node_attributes")):
        node_attrs = np.loadtxt(path("node_attributes"), delimiter=",",
                                dtype=np.float32, ndmin=2)

    # node index ranges per graph (graph_indicator is sorted)
    n_graphs = int(graph_of_node.max()) + 1
    starts = np.searchsorted(graph_of_node, np.arange(n_graphs))
    ends = np.append(starts[1:], n_nodes_total)

    edge_graph = graph_of_node[edges[:, 0]]
    order = np.argsort(edge_graph, kind="stable")
    edges = edges[order]
    edge_graph = edge_graph[order]
    e_starts = np.searchsorted(edge_graph, np.arange(n_graphs))
    e_ends = np.append(e_starts[1:], edges.shape[0])

    graphs = []
    for gid in range(n_graphs):
        lo, hi = starts[gid], ends[gid]
        nn_ = hi - lo
        es, ee = e_starts[gid], e_ends[gid]
        snd = (edges[es:ee, 0] - lo).astype(np.int32)
        rcv = (edges[es:ee, 1] - lo).astype(np.int32)
        feats = []
        if node_labels is not None:
            oh = np.zeros((nn_, n_label_classes), np.float32)
            oh[np.arange(nn_), node_labels[lo:hi]] = 1.0
            feats.append(oh)
        if node_attrs is not None:
            feats.append(node_attrs[lo:hi])
        if feats:
            x = np.concatenate(feats, axis=1) if len(feats) > 1 else feats[0]
            # PyG orders features [attributes, labels] when both present
            if node_labels is not None and node_attrs is not None:
                x = np.concatenate([node_attrs[lo:hi], feats[0]], axis=1)
        else:
            # unlabeled sets: degree one-hot (reference Degree transform)
            x = degree_one_hot(snd, nn_)
        graphs.append(dict(senders=snd, receivers=rcv, n_node=int(nn_),
                           nodes=x.astype(np.float32),
                           y=np.array([y_all[gid]], np.int32)))
    return graphs
