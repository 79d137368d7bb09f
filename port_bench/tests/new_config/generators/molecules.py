"""Batches of molecule-like graphs: a chain of atoms with about half as
many extra bonds, every bond in both directions, OGB's categorical atom
and bond feature columns (each value below its column's vocabulary, as the
traffic gives it) and one float regression target a graph, all from the
seed on the host. The inputs are not one graph with node labels: the
program batches them and the reference concatenates them."""
from __future__ import annotations

import dataclasses

import numpy as np

from port_bench.inputs import SEED_MOD


@dataclasses.dataclass
class MoleculeBatch:
    graphs: list  # dicts of numpy arrays: senders, receivers, n_node, nodes, edges, y
    num_features: int  # atom feature columns
    num_edge_features: int  # bond feature columns
    num_classes: int  # regression targets a graph


def _columns(rng, rows: int, vocab) -> np.ndarray:
    return np.stack([rng.integers(0, v, rows) for v in vocab], axis=1).astype(np.int64)


def make(graph: dict, seed: int, gen, device) -> MoleculeBatch:
    rng = np.random.default_rng(int(seed) % SEED_MOD)
    graphs = []
    for _ in range(int(graph["n_graphs"])):
        n = int(rng.integers(int(graph["min_atoms"]), int(graph["max_atoms"]) + 1))
        extra = n // 2
        snd = np.concatenate([np.arange(n - 1), rng.integers(0, n, extra)])
        rcv = np.concatenate([np.arange(1, n), rng.integers(0, n, extra)])
        senders = np.concatenate([snd, rcv]).astype(np.int32)
        receivers = np.concatenate([rcv, snd]).astype(np.int32)
        graphs.append(dict(senders=senders, receivers=receivers, n_node=n,
                           nodes=_columns(rng, n, graph["atom_vocab"]),
                           edges=_columns(rng, senders.shape[0], graph["bond_vocab"]),
                           y=rng.standard_normal(1).astype(np.float32)))
    return MoleculeBatch(graphs, len(graph["atom_vocab"]), len(graph["bond_vocab"]), 1)
