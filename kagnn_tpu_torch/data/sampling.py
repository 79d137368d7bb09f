"""Layered neighbor sampling for large-graph node classification, the
counterpart of `kagnn_tpu/data/sampling.py::NeighborSampler`.

The GraphSAGE-style sampler: every mini-batch is the union of the seeds'
sampled L-hop in-neighborhoods, assembled as a padded `GraphBatch` whose pad
sizes depend only on (batch_size, fanouts), so every batch of an epoch has
the same shapes.

Conventions, the JAX sampler's:
  * the first `batch_size` rows of the batch are exactly the seed nodes, in
    the order given (`seed_mask()` selects them for losses and metrics);
  * edges point sender -> receiver; sampling walks *incoming* edges so
    messages flow toward the seeds;
  * pads: `n_node_pad = round_up(worst case + 1, 8)` and
    `n_edge_pad = round_up(worst case, 128)`; padded edges point at row
    `n_node_pad - 1`, `node_graph` is 1 on pad rows and `graph_mask` is
    [True, False];
  * the numpy generator is consumed in the JAX sampler's order (one
    `choice` per frontier node of more in-edges than the fanout, one
    `permutation` per epoch), so the same seed gives the same batches.

The batch is built by `graphs/batch.py::_assemble`, so its CSR row pointers
and sender views come from the code every other batch uses.
"""
from __future__ import annotations

from typing import Iterator, Optional, Sequence

import numpy as np
import torch

from kagnn_tpu_torch.graphs.batch import GraphBatch, _assemble, _round_up
from kagnn_tpu_torch.utils.device import resolve_device


class NeighborSampler:
    """Sample fixed-fanout in-neighborhoods around seed nodes, into batches
    on `device` (CUDA unless told otherwise).

    fanouts[l] is the per-node fanout at hop l (hop 0 expands the seeds).
    Pad sizes are the worst case `batch_size * prod(fanouts[:l])` expansion,
    rounded to the node/edge pad multiples, the same for every call.
    """

    def __init__(self, senders, receivers, n_nodes: int,
                 fanouts: Sequence[int], batch_size: int, seed: int = 0,
                 node_pad_multiple: int = 8, edge_pad_multiple: int = 128,
                 device=None):
        senders = np.asarray(senders, np.int32)
        receivers = np.asarray(receivers, np.int32)
        self.device = resolve_device(device)
        self.n_nodes = int(n_nodes)
        self.fanouts = [int(f) for f in fanouts]
        self.batch_size = int(batch_size)
        self._rng = np.random.default_rng(seed)

        # CSR over incoming edges: in_neighbors(v) = senders of edges into v
        order = np.argsort(receivers, kind="stable")
        self._in_nbrs = senders[order]
        self._indptr = np.zeros(self.n_nodes + 1, np.int64)
        np.add.at(self._indptr, receivers + 1, 1)
        np.cumsum(self._indptr, out=self._indptr)

        # static pads from the worst-case expansion
        max_nodes, max_edges, frontier = self.batch_size, 0, self.batch_size
        for f in self.fanouts:
            frontier *= f
            max_edges += frontier
            max_nodes += frontier
        self.n_node_pad = _round_up(max_nodes + 1, node_pad_multiple)
        self.n_edge_pad = _round_up(max(max_edges, 1), edge_pad_multiple)

    def seed_mask(self) -> torch.Tensor:
        """Boolean (n_node_pad,) mask selecting the seed rows, on the
        batches' device."""
        return torch.arange(self.n_node_pad, device=self.device) < self.batch_size

    def sample(self, seeds, node_feat: Optional[np.ndarray] = None,
               y: Optional[np.ndarray] = None) -> GraphBatch:
        """One mini-batch: seeds first, then hop-by-hop sampled neighbors."""
        seeds = np.asarray(seeds, np.int64)
        if seeds.shape[0] != self.batch_size:
            raise ValueError(
                f"got {seeds.shape[0]} seeds, sampler built for "
                f"batch_size={self.batch_size}")
        local = {int(v): i for i, v in enumerate(seeds)}
        node_ids = list(seeds)
        snd_l, rcv_l = [], []
        frontier = seeds
        for f in self.fanouts:
            nxt = []
            for v in frontier:
                lo, hi = self._indptr[v], self._indptr[v + 1]
                deg = int(hi - lo)
                if deg == 0:
                    continue
                if deg <= f:
                    picked = self._in_nbrs[lo:hi]
                else:
                    picked = self._in_nbrs[
                        lo + self._rng.choice(deg, f, replace=False)]
                rv = local[int(v)]
                for u in picked:
                    ui = local.get(int(u))
                    if ui is None:
                        ui = len(node_ids)
                        local[int(u)] = ui
                        node_ids.append(int(u))
                    snd_l.append(ui)
                    rcv_l.append(rv)
                nxt.append(picked)
            frontier = (np.unique(np.concatenate(nxt)) if nxt
                        else np.zeros(0, np.int64))

        n_node = len(node_ids)
        n_edge = len(snd_l)
        node_ids = np.asarray(node_ids, np.int64)
        snd = np.asarray(snd_l, np.int32)
        rcv = np.asarray(rcv_l, np.int32)
        if n_edge:
            order = np.argsort(rcv, kind="stable")
            snd, rcv = snd[order], rcv[order]
        pad_e = self.n_edge_pad - n_edge
        snd = np.concatenate(
            [snd, np.full(pad_e, self.n_node_pad - 1, np.int32)])
        rcv = np.concatenate(
            [rcv, np.full(pad_e, self.n_node_pad - 1, np.int32)])

        node_mask = np.arange(self.n_node_pad) < n_node
        node_graph = np.where(node_mask, 0, 1).astype(np.int32)

        nodes = None
        if node_feat is not None:
            nf = np.asarray(node_feat)[node_ids]
            nodes = np.concatenate(
                [nf, np.zeros((self.n_node_pad - n_node,) + nf.shape[1:],
                              nf.dtype)])
        yb = None
        if y is not None:
            yv = np.asarray(y)[node_ids]
            yb = np.concatenate(
                [yv, np.zeros((self.n_node_pad - n_node,) + yv.shape[1:],
                              yv.dtype)])

        return _assemble(self.device, snd, rcv, nodes, None, yb, node_mask,
                         np.arange(self.n_edge_pad) < n_edge,
                         np.array([True, False]), node_graph, n_node, n_edge, 1)

    def epoch(self, train_nodes, node_feat=None, y=None
              ) -> Iterator[GraphBatch]:
        """Shuffled full batches over `train_nodes` (the remainder dropped,
        as in the JAX sampler: every batch keeps the same shapes)."""
        train_nodes = np.asarray(train_nodes, np.int64)
        perm = self._rng.permutation(train_nodes.shape[0])
        for lo in range(0, train_nodes.shape[0] - self.batch_size + 1,
                        self.batch_size):
            yield self.sample(train_nodes[perm[lo:lo + self.batch_size]],
                              node_feat, y)
