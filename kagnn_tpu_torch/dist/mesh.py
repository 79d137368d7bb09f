"""Rank layouts, the counterpart of `kagnn_tpu/dist/mesh.py`.

The JAX package lays its devices out on a named mesh: axis "data" for data
parallelism over padded GraphBatches, axis "graph" for the edge partition
within a batch (edge leaves sharded, node leaves replicated). Here the
ranks of the default process group are laid out the same way, and each
axis becomes this rank's subgroup along it (`dist.new_group`), the group
its collectives run over. `graph_batch_shardings` becomes the slicing of a
GraphBatch's edge leaves to this rank's place on the graph axis.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from kagnn_tpu_torch.graphs.batch import GraphBatch, _row_ptr

EDGE_LEAVES = ("senders", "receivers", "edge_mask", "edges")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The world's ranks laid out on named axes, seen from one rank."""

    axis_names: tuple
    shape: tuple
    rank: int
    coords: tuple        # this rank's index along each axis
    groups: tuple        # this rank's group along each axis (None: size 1)

    def _i(self, axis: str) -> int:
        return self.axis_names.index(axis)

    def size(self, axis: str) -> int:
        return self.shape[self._i(axis)]

    def coord(self, axis: str) -> int:
        return self.coords[self._i(axis)]

    def group(self, axis: str):
        return self.groups[self._i(axis)]


def make_mesh(shape: Optional[Sequence[int]] = None,
              axis_names: Sequence[str] = ("data", "graph")) -> Mesh:
    """Lay the default group's ranks out on `axis_names` (row-major, as the
    JAX mesh reshapes its devices). Default: every rank on the first axis.
    Every rank must call it, with the same arguments: each subgroup is made
    by all ranks in the same order."""
    world, rank = dist.get_world_size(), dist.get_rank()
    if shape is None:
        shape = (world,) + (1,) * (len(axis_names) - 1)
    shape = tuple(int(s) for s in shape)
    if int(np.prod(shape)) != world:
        raise ValueError(f"mesh shape {shape} != {world} ranks")
    ranks = np.arange(world).reshape(shape)
    coords = tuple(int(c) for c in np.argwhere(ranks == rank)[0])
    groups = []
    for i, n in enumerate(shape):
        if n == 1:
            groups.append(None)
            continue
        if n == world:
            groups.append(dist.group.WORLD)
            continue
        mine = None
        lines = np.moveaxis(ranks, i, -1).reshape(-1, n)
        for line in lines:
            grp = dist.new_group([int(r) for r in line])
            if rank in line:
                mine = grp
        groups.append(mine)
    return Mesh(tuple(axis_names), shape, rank, coords, tuple(groups))


def with_edges(g: GraphBatch, senders: np.ndarray, receivers: np.ndarray,
               edge_mask: np.ndarray, edges: Optional[np.ndarray]) -> GraphBatch:
    """g with new (receiver-sorted) edge leaves and the edge fields derived
    from them rebuilt on the host: the sender sort and the two row pointers
    (padded edges counted in the last row, as graphs/batch.py builds them).
    The node leaves stay, in_degrees (the global count) among them."""
    n_pad = g.n_node_pad
    perm = np.argsort(senders, kind="stable").astype(np.int32)
    ss = senders[perm]
    dev = g.device

    def t(a):
        return None if a is None else torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    return g.replace(senders=t(senders), receivers=t(receivers),
                     edge_mask=t(edge_mask), edges=t(edges), senders_perm=t(perm),
                     senders_sorted=t(ss), receivers_by_sender=t(receivers[perm]),
                     edge_mask_by_sender=t(edge_mask[perm]),
                     recv_row_ptr=t(_row_ptr(receivers, n_pad)),
                     send_row_ptr=t(_row_ptr(ss, n_pad)))


def _host(g: GraphBatch):
    return {k: None if getattr(g, k) is None else getattr(g, k).detach().cpu().numpy()
            for k in EDGE_LEAVES}


def edge_shard(g: GraphBatch, index: int, n: int) -> GraphBatch:
    """Shard `index` of n of g's edge leaves: the contiguous slice of the
    receiver-sorted edge list (its length must divide by n, see
    partition.pad_edges_to), with the node leaves whole."""
    e = g.n_edge_pad
    if e % n:
        raise ValueError(f"{e} edges do not split into {n} shards; "
                         f"pad them first (dist/partition.pad_edges_to)")
    k = e // n
    h = _host(g)
    sl = slice(index * k, (index + 1) * k)
    return with_edges(g, h["senders"][sl], h["receivers"][sl], h["edge_mask"][sl],
                      None if h["edges"] is None else h["edges"][sl])


def graph_batch_shardings(mesh: Mesh, stacked: bool = True,
                          data_axis: str = "data",
                          edge_axis: Optional[str] = "graph"):
    """A function from a (stacked) batch to this rank's part of it: with
    `stacked`, the replica of its data coordinate; then, with an edge axis
    of more than one rank, the edge shard of its graph coordinate."""
    def build(g):
        if stacked:
            g = g[mesh.coord(data_axis)]
        if edge_axis is not None and mesh.size(edge_axis) > 1:
            g = edge_shard(g, mesh.coord(edge_axis), mesh.size(edge_axis))
        return g
    return build
