"""Graph reordering for memory locality, the counterpart of
`kagnn_tpu/graphs/reorder.py` (numpy, verbatim).

The neighbor gather `x[senders]` is the bandwidth-bound part of full-graph
message passing: random node ids mean random HBM rows. Real-world graphs
(citation networks, molecules) have strong community structure, so renumbering
nodes such that connected nodes get nearby ids turns most gathers into
near-sequential reads. This module provides:

  * `bfs_order` — Cuthill–McKee-style BFS renumbering from lowest-degree
    seeds (bandwidth-reducing);
  * `degree_order` — hubs-first renumbering (groups the hot rows);
  * `reorder_graph` — apply a permutation to a node-task dataset dict
    (features, labels, masks, edges) consistently.

No counterpart in the reference (it inherits whatever order the dataset
ships with).
"""
from __future__ import annotations

from typing import Callable

import numpy as np


def bfs_order(senders: np.ndarray, receivers: np.ndarray,
              n_node: int, reverse: bool = True) -> np.ndarray:
    """Permutation `perm` with new_id = perm_inv[old_id]; BFS from
    lowest-degree seeds over the undirected structure (reverse Cuthill–McKee
    when `reverse`). Returns old ids in visit order (perm[new] = old)."""
    deg = np.bincount(senders, minlength=n_node) + np.bincount(
        receivers, minlength=n_node)
    # CSR over the union of both directions
    und_s = np.concatenate([senders, receivers])
    und_r = np.concatenate([receivers, senders])
    order = np.argsort(und_s, kind="stable")
    und_s, und_r = und_s[order], und_r[order]
    indptr = np.zeros(n_node + 1, np.int64)
    np.cumsum(np.bincount(und_s, minlength=n_node), out=indptr[1:])

    visited = np.zeros(n_node, bool)
    out = np.empty(n_node, np.int64)
    pos = 0
    for seed in np.argsort(deg, kind="stable"):
        if visited[seed]:
            continue
        queue = [int(seed)]
        visited[seed] = True
        while queue:
            nxt: list[int] = []
            for v in queue:
                out[pos] = v
                pos += 1
                nbrs = und_r[indptr[v]:indptr[v + 1]]
                fresh = nbrs[~visited[nbrs]]
                if len(fresh):
                    fresh = np.unique(fresh)
                    visited[fresh] = True
                    # visit low-degree neighbors first (CM heuristic)
                    nxt.extend(fresh[np.argsort(deg[fresh])].tolist())
            queue = nxt
    assert pos == n_node
    return out[::-1].copy() if reverse else out


def degree_order(senders: np.ndarray, receivers: np.ndarray,
                 n_node: int) -> np.ndarray:
    """Old ids sorted by descending degree (hubs first)."""
    deg = np.bincount(senders, minlength=n_node) + np.bincount(
        receivers, minlength=n_node)
    return np.argsort(-deg, kind="stable")


def reorder_graph(d: dict, order_fn: Callable = bfs_order) -> dict:
    """Renumber a node-task dataset dict (as returned by the loaders:
    senders/receivers/nodes/y/n_node + optional *_masks) so new id i is old
    id perm[i]. Returns a NEW dict."""
    n = int(d["n_node"])
    perm = order_fn(np.asarray(d["senders"]), np.asarray(d["receivers"]), n)
    inv = np.empty(n, np.int64)
    inv[perm] = np.arange(n)
    out = dict(d)
    out["senders"] = inv[np.asarray(d["senders"])].astype(np.int32)
    out["receivers"] = inv[np.asarray(d["receivers"])].astype(np.int32)
    for key in ("nodes", "y"):
        if d.get(key) is not None:
            out[key] = np.asarray(d[key])[perm]
    for key in ("train_masks", "val_masks", "test_masks"):
        if d.get(key) is not None:
            out[key] = np.asarray(d[key])[:, perm]
    if "masks" in d:
        out["masks"] = {k: np.asarray(v)[perm] for k, v in d["masks"].items()}
    out["reorder_perm"] = perm
    return out
