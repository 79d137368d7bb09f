"""Synthetic graph generators (numpy only), copied from the JAX package's
`kagnn_tpu/data/synthetic.py` so that the port needs nothing of it. The
functions are kept verbatim: the same seed gives the same graph in both
packages."""
from __future__ import annotations

import numpy as np


def community_node_graph(n_nodes: int = 200, n_classes: int = 4,
                         num_features: int = 16, avg_degree: int = 8,
                         p_intra: float = 0.85, seed: int = 0):
    """Stochastic-block-model-style node-classification graph: features are
    class-informative Gaussians, edges mostly intra-class. Returns a dict
    compatible with `kagnn_tpu_torch.graphs.single_graph` plus masks."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, n_classes, n_nodes).astype(np.int32)
    centers = rng.normal(size=(n_classes, num_features)) * 1.2
    x = (centers[labels] + rng.normal(size=(n_nodes, num_features))).astype(
        np.float32)
    n_edges = n_nodes * avg_degree // 2
    snd, rcv = [], []
    members = [np.flatnonzero(labels == c) for c in range(n_classes)]
    for _ in range(n_edges):
        a = int(rng.integers(0, n_nodes))
        if rng.random() < p_intra:
            b = int(rng.choice(members[labels[a]]))
        else:
            b = int(rng.integers(0, n_nodes))
        snd += [a, b]
        rcv += [b, a]
    idx = rng.permutation(n_nodes)
    n_tr = int(0.6 * n_nodes)
    n_va = int(0.2 * n_nodes)
    masks = {}
    for name, sl in [("train", idx[:n_tr]), ("val", idx[n_tr:n_tr + n_va]),
                     ("test", idx[n_tr + n_va:])]:
        m = np.zeros(n_nodes, bool)
        m[sl] = True
        masks[name] = m
    return dict(senders=np.asarray(snd, np.int32),
                receivers=np.asarray(rcv, np.int32), nodes=x, y=labels,
                n_node=n_nodes, masks=masks)


def random_molecule_graphs(n_graphs: int = 60, min_nodes: int = 6,
                           max_nodes: int = 24, num_atom_types: int = 21,
                           num_bond_types: int = 4, seed: int = 0,
                           target: str = "classification",
                           n_classes: int = 2):
    """ZINC/MUTAG-like small graphs with categorical node/edge features.

    Targets: 'classification' — label correlated with mean atom type;
    'regression' — a smooth function of graph statistics (so models can
    actually learn it)."""
    rng = np.random.default_rng(seed)
    graphs = []
    for _ in range(n_graphs):
        n = int(rng.integers(min_nodes, max_nodes + 1))
        atom = rng.integers(0, num_atom_types, (n, 1)).astype(np.int32)
        # random connected-ish chain + extra edges
        snd = list(range(n - 1))
        rcv = list(range(1, n))
        extra = n // 2
        snd += list(rng.integers(0, n, extra))
        rcv += list(rng.integers(0, n, extra))
        snd, rcv = np.asarray(snd), np.asarray(rcv)
        both_s = np.concatenate([snd, rcv]).astype(np.int32)
        both_r = np.concatenate([rcv, snd]).astype(np.int32)
        bond = rng.integers(0, num_bond_types,
                            (both_s.shape[0], 1)).astype(np.int32)
        stat = atom.mean() / num_atom_types + 0.1 * (len(both_s) / n)
        if target == "classification":
            y = np.array([int(stat > 0.5 + 0.1)], np.int32)
        else:
            y = np.array([float(np.sin(3 * stat) + 0.5 * stat)], np.float32)
        graphs.append(dict(senders=both_s, receivers=both_r, n_node=n,
                           nodes=atom, edges=bond, y=y))
    return graphs


def arxiv_scale_graph(n_nodes: int = 169_343, n_edges: int = 1_166_243,
                      num_features: int = 128, n_classes: int = 40,
                      seed: int = 0):
    """ogbn-arxiv-sized random graph (same node/edge counts) for throughput
    benchmarking — the reference's timing harness target
    (node_classification_clean/time_model.py:25-26)."""
    rng = np.random.default_rng(seed)
    # power-law-ish degree distribution via preferential attachment sampling
    snd = rng.integers(0, n_nodes, n_edges).astype(np.int32)
    rcv = np.floor(n_nodes * rng.random(n_edges) ** 2.0).astype(np.int32)
    x = rng.normal(size=(n_nodes, num_features)).astype(np.float32)
    y = rng.integers(0, n_classes, n_nodes).astype(np.int32)
    return dict(senders=snd, receivers=rcv, nodes=x, y=y, n_node=n_nodes)
