"""Data-parallel training steps, the counterpart of
`kagnn_tpu/dist/sharded.py`.

The JAX step vmaps the per-replica loss over a stacked leading batch axis
and shards it over the mesh's "data" axis (and each replica's edge leaves
over "graph"); the loss is the mean over the replicas, so the gradient is
their mean, and the BatchNorm running statistics are averaged over them
(sync-BN style). Here each rank takes one replica's padded batch: the
replica of its data coordinate and, with a "graph" axis of more than one
rank, the edge shard of its graph coordinate (dist/mesh.py). Each rank
runs its replica's loss and backward; the gradients and the running
statistics are then averaged over all ranks and every rank takes the same
optimizer step. The mean over the graph axis is the edge partition's own
(dist/partition.py); over the data axis, the mean of the replicas'
gradients.
"""
from __future__ import annotations

from typing import Callable, Sequence

import torch
import torch.distributed as dist

from kagnn_tpu_torch.dist.halo import average_grads
from kagnn_tpu_torch.dist.mesh import Mesh, graph_batch_shardings, make_mesh
from kagnn_tpu_torch.graphs.batch import GraphBatch
from kagnn_tpu_torch.ops import segment
from kagnn_tpu_torch.ops.norm import MaskedBatchNorm


def stack_batches(batches: Sequence[GraphBatch]) -> tuple:
    """The replicas' equally padded batches, one for each data coordinate
    (the JAX function stacks them along a new leading axis)."""
    shapes = {(b.n_node_pad, b.n_edge_pad, b.n_graph_pad) for b in batches}
    if len(shapes) != 1:
        raise ValueError(f"the replicas' batches must share one padding, got {shapes}")
    return tuple(batches)


def shard_stacked_batch(mesh: Mesh, stacked, data_axis: str = "data",
                        edge_axis: str | None = "graph") -> GraphBatch:
    """This rank's part of a stacked batch: its data coordinate's replica,
    with the edge shard of its graph coordinate when that axis has more
    than one rank (the JAX function places each leaf's shards on their
    devices)."""
    return graph_batch_shardings(mesh, True, data_axis, edge_axis)(stacked)


def average_running_stats(model, group, n: int) -> None:
    """Average every MaskedBatchNorm's running mean and variance over the
    group's n ranks (the JAX step's mean of the replicas' batch stats)."""
    for mod in model.modules():
        if isinstance(mod, MaskedBatchNorm):
            for buf in (mod.running_mean, mod.running_var):
                buf.copy_(segment.all_reduce(buf, group=group) / n)


def make_sharded_train_step(model, optimizer,
                            loss_of_output: Callable[[torch.Tensor, GraphBatch], torch.Tensor],
                            mesh: Mesh | None = None, data_axis: str = "data",
                            edge_axis: str | None = "graph"):
    """A data (+ graph) parallel train step: step(stacked) -> the mean loss
    over the replicas, where `stacked` is `stack_batches`' tuple (every rank
    passes the same). `mesh` defaults to every rank on the data axis."""
    if mesh is None:
        mesh = make_mesh((dist.get_world_size(),) + ((1,) if edge_axis else ()),
                         (data_axis,) + ((edge_axis,) if edge_axis else ()))
    world = dist.get_world_size()
    egroup = (mesh.group(edge_axis)
              if edge_axis is not None and mesh.size(edge_axis) > 1 else None)
    params = list(model.parameters())
    cache: dict = {}

    def step(stacked) -> torch.Tensor:
        if cache.get("stacked") is not stacked:
            cache.update(stacked=stacked,
                         batch=shard_stacked_batch(mesh, stacked, data_axis, edge_axis))
        batch = cache["batch"]
        model.train()
        optimizer.zero_grad(set_to_none=True)
        with segment.edge_axis(egroup):
            loss = loss_of_output(model(batch), batch)
        loss.backward()
        average_grads(params, None, world)
        with torch.no_grad():
            average_running_stats(model, None, world)
        optimizer.step()
        return segment.all_reduce(loss.detach(), group=None) / world

    return step
