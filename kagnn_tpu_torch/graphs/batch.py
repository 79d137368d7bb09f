"""Statically padded graph containers and the block-diagonal batcher, the
counterparts of `kagnn_tpu/graphs/batch.py` (`GraphBatch`, `single_graph`,
`PadSpec`, `pad_spec_for`, `batch_graphs`).

The invariants are the JAX package's:

  * edges are sorted by receiver (stable argsort), edge features with them;
  * padded nodes, edges and graphs are appended at the end and flagged off
    by the masks; every padded node belongs to the last (padding) graph,
    so `node_graph` is ascending;
  * padded edges point at the masked last row `n_node_pad - 1`;
  * `n_node_pad = round_up(n + 1, node_pad_multiple)` always leaves one
    pad row;
  * `in_degrees` counts valid edges only;
  * the sender-sorted views `senders_perm`, `senders_sorted`,
    `receivers_by_sender` and `edge_mask_by_sender` are built on the host.

The port adds three CSR row pointers, built on the host: `recv_row_ptr`
(N+1) over the receiver-sorted edges and `send_row_ptr` (N+1) over
`senders_sorted`, with the padded edges counted in the last row of each, so
every edge of the padded arrays belongs to exactly one row; and
`graph_row_ptr` (G+1) over the ascending `node_graph`, where the pad nodes
fall in the last graph and the empty pad graphs are empty rows. The Hopper
kernels walk these rows (kernels/gin_fused.py, kernels/spmm.py; the pools
and GINE through ops/segment.py).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch

from kagnn_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class GraphBatch:
    """A padded batch of graphs (possibly a single graph). N = n_node_pad,
    E = n_edge_pad, G = n_graph_pad.

    Every index is in range, 0 <= idx < N, with padded edges pointing at
    the masked last row N-1."""

    senders: torch.Tensor  # (E,) int32, receiver-sorted edge order
    receivers: torch.Tensor  # (E,) int32, ascending
    nodes: Optional[torch.Tensor]  # (N, F)
    edges: Optional[torch.Tensor]  # (E, Fe), receiver-sorted
    y: Optional[torch.Tensor]  # (G, ...) graph or (N, ...) node targets
    node_mask: torch.Tensor  # (N,) bool
    edge_mask: torch.Tensor  # (E,) bool
    graph_mask: torch.Tensor  # (G,) bool
    node_graph: torch.Tensor  # (N,) int32, ascending
    n_node: int
    n_edge: int
    n_graph: int
    senders_perm: torch.Tensor  # (E,) int32: senders[perm] == senders_sorted
    senders_sorted: torch.Tensor  # (E,) int32, ascending
    receivers_by_sender: torch.Tensor  # (E,) int32
    edge_mask_by_sender: torch.Tensor  # (E,) bool
    in_degrees: torch.Tensor  # (N,) int32, valid edges only
    recv_row_ptr: torch.Tensor  # (N+1,) int32 CSR over receivers
    send_row_ptr: torch.Tensor  # (N+1,) int32 CSR over senders_sorted
    graph_row_ptr: torch.Tensor  # (G+1,) int32 CSR over node_graph

    @property
    def n_node_pad(self) -> int:
        return self.node_mask.shape[0]

    @property
    def n_edge_pad(self) -> int:
        return self.edge_mask.shape[0]

    @property
    def n_graph_pad(self) -> int:
        return self.graph_mask.shape[0]

    @property
    def device(self) -> torch.device:
        return self.senders.device

    def replace(self, **kw: Any) -> "GraphBatch":
        return dataclasses.replace(self, **kw)

    def map_tensors(self, fn: Callable[[torch.Tensor], torch.Tensor]) -> "GraphBatch":
        """A batch with fn applied to every tensor field."""
        return self.replace(**{
            f.name: fn(v) for f in dataclasses.fields(self)
            if isinstance(v := getattr(self, f.name), torch.Tensor)})

    def tensors(self) -> list[torch.Tensor]:
        return [v for f in dataclasses.fields(self)
                if isinstance(v := getattr(self, f.name), torch.Tensor)]

    def to(self, device, non_blocking: bool = False) -> "GraphBatch":
        dev = resolve_device(device)
        return self.map_tensors(lambda t: t.to(dev, non_blocking=non_blocking))


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _row_ptr(sorted_rows: np.ndarray, n_rows: int) -> np.ndarray:
    counts = np.bincount(sorted_rows, minlength=n_rows)
    return np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)


def _assemble(dev, senders, receivers, nodes, edges, y, node_mask, edge_mask,
              graph_mask, node_graph, n_node, n_edge, n_graph, perm=None,
              senders_sorted=None) -> GraphBatch:
    """The host arrays of a padded, receiver-sorted batch -> a GraphBatch on
    `dev`. Every batcher ends here, so the derived fields are built in one
    place: the valid in-degrees, the sender sort (unless the caller, the
    native assembler, has it), the receivers and mask in sender order and
    the three row pointers."""
    n_pad, g_pad = node_mask.shape[0], graph_mask.shape[0]
    if perm is None:
        perm = np.argsort(senders, kind="stable").astype(np.int32)
        senders_sorted = senders[perm]
    in_deg = np.bincount(receivers[edge_mask], minlength=n_pad).astype(np.int32)

    def t(a):
        return None if a is None else torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    return GraphBatch(
        senders=t(senders), receivers=t(receivers), nodes=t(nodes),
        edges=t(edges), y=t(y), node_mask=t(node_mask),
        edge_mask=t(edge_mask), graph_mask=t(graph_mask),
        node_graph=t(node_graph), n_node=int(n_node), n_edge=int(n_edge),
        n_graph=int(n_graph), senders_perm=t(perm),
        senders_sorted=t(senders_sorted), receivers_by_sender=t(receivers[perm]),
        edge_mask_by_sender=t(edge_mask[perm]), in_degrees=t(in_deg),
        recv_row_ptr=t(_row_ptr(receivers, n_pad)),
        send_row_ptr=t(_row_ptr(senders_sorted, n_pad)),
        graph_row_ptr=t(_row_ptr(node_graph, g_pad)))


def single_graph(
    senders: np.ndarray,
    receivers: np.ndarray,
    nodes: Optional[np.ndarray] = None,
    y: Optional[np.ndarray] = None,
    n_node: Optional[int] = None,
    node_pad_multiple: int = 8,
    edge_pad_multiple: int = 128,
    device=None,
) -> GraphBatch:
    """Wrap one graph (e.g. a full-batch node-classification graph) into a
    padded `GraphBatch` with one valid graph, on `device` (CUDA unless told
    otherwise)."""
    dev = resolve_device(device)
    senders = np.asarray(senders, np.int32)
    receivers = np.asarray(receivers, np.int32)
    if n_node is None:
        n_node = int(nodes.shape[0]) if nodes is not None else int(
            max(senders.max(initial=-1), receivers.max(initial=-1)) + 1)
    n_edge = int(senders.shape[0])
    if n_edge and (int(senders.min()) < 0 or int(senders.max()) >= n_node
                   or int(receivers.min()) < 0
                   or int(receivers.max()) >= n_node):
        raise ValueError(
            f"edge indices out of range [0, {n_node}): senders in "
            f"[{senders.min()}, {senders.max()}], receivers in "
            f"[{receivers.min()}, {receivers.max()}]")
    n_pad = _round_up(max(n_node, 1) + 1, node_pad_multiple)
    e_pad = _round_up(max(n_edge, 1), edge_pad_multiple)

    if n_edge > 0:
        order = np.argsort(receivers, kind="stable")
        senders, receivers = senders[order], receivers[order]

    pad_e = e_pad - n_edge
    senders = np.concatenate([senders, np.full(pad_e, n_pad - 1, np.int32)])
    receivers = np.concatenate([receivers, np.full(pad_e, n_pad - 1, np.int32)])
    edge_mask = np.arange(e_pad) < n_edge
    node_mask = np.arange(n_pad) < n_node
    node_graph = np.where(node_mask, 0, 1).astype(np.int32)

    if nodes is not None:
        nodes = np.asarray(nodes)
        nodes = np.concatenate(
            [nodes, np.zeros((n_pad - nodes.shape[0],) + nodes.shape[1:],
                             nodes.dtype)])
    if y is not None:
        y = np.asarray(y)
        if y.ndim >= 1 and y.shape[0] == n_node:
            y = np.concatenate(
                [y, np.zeros((n_pad - n_node,) + y.shape[1:], y.dtype)])

    return _assemble(dev, senders, receivers, nodes, None, y, node_mask,
                     edge_mask, np.array([True, False]), node_graph, n_node,
                     n_edge, 1)


@dataclasses.dataclass(frozen=True)
class PadSpec:
    """Static pad sizes of a bucket: every batch of one PadSpec has the
    same shapes."""

    n_node: int
    n_edge: int
    n_graph: int


def pad_spec_for(
    graphs: Sequence[dict],
    batch_size: int,
    node_pad_multiple: int = 8,
    edge_pad_multiple: int = 128,
) -> PadSpec:
    """A single PadSpec covering every `batch_size`-sized batch of
    `graphs` (dicts with 'senders'/'receivers'/'n_node')."""
    sizes_n = sorted((int(g["n_node"]) for g in graphs), reverse=True)
    sizes_e = sorted((len(g["senders"]) for g in graphs), reverse=True)
    worst_n = sum(sizes_n[:batch_size])
    worst_e = sum(sizes_e[:batch_size])
    return PadSpec(
        n_node=_round_up(worst_n + 1, node_pad_multiple),
        n_edge=_round_up(max(worst_e, 1), edge_pad_multiple),
        n_graph=batch_size + 1,
    )


def batch_graphs(
    graphs: Sequence[dict],
    spec: PadSpec,
    device=None,
) -> GraphBatch:
    """Block-diagonally collate a list of graphs into one padded GraphBatch
    on `device` (CUDA unless told otherwise).

    Each graph dict carries numpy arrays: 'senders', 'receivers', 'n_node',
    and optionally 'nodes', 'edges', 'y'."""
    dev = resolve_device(device)
    assert len(graphs) <= spec.n_graph - 1, "batch larger than PadSpec.n_graph-1"
    senders, receivers, node_feats, edge_feats, ys = [], [], [], [], []
    node_graph = []
    offset = 0
    for gid, g in enumerate(graphs):
        nn_ = int(g["n_node"])
        s = np.asarray(g["senders"], np.int32)
        r = np.asarray(g["receivers"], np.int32)
        if s.size and (int(s.min()) < 0 or int(s.max()) >= nn_
                       or int(r.min()) < 0 or int(r.max()) >= nn_):
            # an index >= this graph's n_node would alias into the next
            # graph's rows after the offset shift
            raise ValueError(
                f"graph {gid}: edge indices out of range [0, {nn_})")
        senders.append(s + offset)
        receivers.append(r + offset)
        node_graph.append(np.full(nn_, gid, np.int32))
        if g.get("nodes") is not None:
            node_feats.append(np.asarray(g["nodes"]))
        if g.get("edges") is not None:
            edge_feats.append(np.asarray(g["edges"]))
        if g.get("y") is not None:
            ys.append(np.asarray(g["y"]).reshape(1, -1))
        offset += nn_

    n_node = offset
    senders = np.concatenate(senders) if senders else np.zeros(0, np.int32)
    receivers = np.concatenate(receivers) if receivers else np.zeros(0, np.int32)
    n_edge = senders.shape[0]
    assert n_node < spec.n_node and n_edge <= spec.n_edge, (
        f"batch ({n_node} nodes, {n_edge} edges) exceeds PadSpec {spec}")

    if n_edge > 0:
        order = np.argsort(receivers, kind="stable")
        senders, receivers = senders[order], receivers[order]
        if edge_feats:
            edge_feats = [np.concatenate(edge_feats)[order]]

    pad_e = spec.n_edge - n_edge
    senders = np.concatenate([senders, np.full(pad_e, spec.n_node - 1, np.int32)])
    receivers = np.concatenate([receivers, np.full(pad_e, spec.n_node - 1, np.int32)])
    edge_mask = np.arange(spec.n_edge) < n_edge
    node_mask = np.arange(spec.n_node) < n_node
    node_graph = np.concatenate(
        [np.concatenate(node_graph) if node_graph else np.zeros(0, np.int32),
         np.full(spec.n_node - n_node, spec.n_graph - 1, np.int32)])
    graph_mask = np.arange(spec.n_graph) < len(graphs)

    nodes = None
    if node_feats:
        nf = np.concatenate(node_feats)
        nodes = np.concatenate(
            [nf, np.zeros((spec.n_node - nf.shape[0],) + nf.shape[1:], nf.dtype)])
    edges = None
    if edge_feats:
        ef = np.concatenate(edge_feats) if len(edge_feats) > 1 else edge_feats[0]
        edges = np.concatenate(
            [ef, np.zeros((spec.n_edge - ef.shape[0],) + ef.shape[1:], ef.dtype)])
    y = None
    if ys:
        yv = np.concatenate(ys)
        pad_y = np.zeros((spec.n_graph - yv.shape[0],) + yv.shape[1:], yv.dtype)
        y = np.concatenate([yv, pad_y])
        if y.shape[-1] == 1:
            y = y[..., 0]

    return _assemble(dev, senders, receivers, nodes, edges, y, node_mask,
                     edge_mask, graph_mask, node_graph, n_node, n_edge,
                     len(graphs))
