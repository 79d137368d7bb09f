"""The edge partition, the counterpart of `kagnn_tpu/dist/partition.py`:
full-graph training with the edge list sharded over the ranks of a group
and the node arrays replicated on every rank.

Each rank aggregates its edge shard; `ops.segment.edge_axis` arms every
edge->node reduction with the matching all-reduce (SUM, or MAX for the
softmax's shift), so the conv stack runs unchanged. The pools suspend it.
No fused GCN or GAT kernel runs under it, as in the JAX package, and a
fused GIN aggregate is refused (kan/layers.py): the JAX step refuses it
too.

The JAX step needs no gradient all-reduce of its own: under
`shard_map(check_vma=True)` the replicated parameters enter the edge shard
through an implicit broadcast whose transpose sums over the axis. Here the
all-reduce's backward sums the cotangents and every rank's loss is the
global one, so the summed gradients are D times the global gradient and
the step averages them over the ranks (dist/halo.py's arithmetic).
"""
from __future__ import annotations

import time
from typing import Callable

import numpy as np
import torch
import torch.distributed as dist

from kagnn_tpu_torch.dist.halo import _sync, average_grads
from kagnn_tpu_torch.dist.mesh import _host, edge_shard, with_edges
from kagnn_tpu_torch.graphs.batch import GraphBatch
from kagnn_tpu_torch.ops import segment
from kagnn_tpu_torch.train import losses


def pad_edges_to(g: GraphBatch, multiple: int) -> GraphBatch:
    """Repad the edge axis so it divides the partition count: the new
    padded edges point at the masked last row, as the batchers pad."""
    e = g.n_edge_pad
    pad = (-e) % multiple
    if pad == 0:
        return g
    h = _host(g)
    fill = g.n_node_pad - 1
    edges = h["edges"]
    if edges is not None:
        edges = np.concatenate([edges, np.zeros((pad,) + edges.shape[1:], edges.dtype)])
    return with_edges(
        g, np.concatenate([h["senders"], np.full(pad, fill, h["senders"].dtype)]),
        np.concatenate([h["receivers"], np.full(pad, fill, h["receivers"].dtype)]),
        np.concatenate([h["edge_mask"], np.zeros(pad, bool)]), edges)


def make_edge_partitioned_node_step(model, optimizer, group=None):
    """A full-graph node-classification train step with the edge list
    sharded over `group` (the default group when None): step(graph, mask)
    -> loss, the signature of `make_node_steps`' train step. Every rank
    passes the same graph and mask; the rank's edge shard is cut once per
    graph."""
    group = dist.group.WORLD if group is None else group
    n = dist.get_world_size(group)
    rank = dist.get_rank(group)
    params = list(model.parameters())
    cache: dict = {}

    def step(g: GraphBatch, mask) -> torch.Tensor:
        if cache.get("g") is not g:
            cache.update(g=g, shard=edge_shard(pad_edges_to(g, n), rank, n))
        shard = cache["shard"]
        model.train()
        optimizer.zero_grad(set_to_none=True)
        with segment.edge_axis(group):
            out = model(shard)
            loss = losses.masked_softmax_cross_entropy(out, shard.y, mask)
        loss.backward()
        average_grads(params, group, n)
        optimizer.step()
        return loss.detach()

    return step


def scaling_report_rank(rank: int, world: int, model_fn, n: int,
                        iters: int) -> dict:
    """One rank's share of `scaling_report` at n = world edge shards (a
    dist/launch.py rank)."""
    group = None
    model, optimizer, g, mask = model_fn()
    step = make_edge_partitioned_node_step(model, optimizer, group)
    device = next(model.parameters()).device
    step(g, mask)
    _sync(device)
    dist.barrier(group)
    t0 = time.perf_counter()
    for _ in range(iters):
        loss = step(g, mask)
    _sync(device)
    sec = (time.perf_counter() - t0) / iters
    return {"n_devices": n, "sec_per_step": sec,
            "edges_per_s": int(g.n_edge) / sec, "loss": float(loss)}


def scaling_report(model_fn: Callable, n_devices_list=(1, 2, 4, 8),
                   iters: int = 5, backend: str = "nccl", device: str = "cuda",
                   timeout: float = 1800.0) -> list[dict]:
    """edges/s at several edge-partition widths, each run as that many ranks
    (dist/launch.py); model_fn and the check of every count before the
    first run as `halo.halo_scaling_report`'s. Each row's seconds are the
    slowest rank's."""
    from kagnn_tpu_torch.dist.launch import check_backend, launch

    for n in n_devices_list:
        check_backend(backend, n, device)
    rows = []
    for n in n_devices_list:
        got = launch(scaling_report_rank, n, (model_fn, n, iters),
                     backend=backend, device=device, timeout=timeout)
        sec = max(r["sec_per_step"] for r in got)
        rows.append(dict(got[0], sec_per_step=sec,
                         edges_per_s=got[0]["edges_per_s"] * got[0]["sec_per_step"] / sec))
    if rows:
        base = rows[0]["edges_per_s"]
        for r in rows:
            r["scaling_efficiency"] = r["edges_per_s"] / (base * r["n_devices"])
    return rows
