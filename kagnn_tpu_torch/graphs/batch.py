"""Statically padded graph container, the counterpart of
`kagnn_tpu/graphs/batch.py` (`GraphBatch`, `single_graph`).

The invariants are the JAX package's:

  * edges are sorted by receiver (stable argsort);
  * padded edges point at the masked last row `n_node_pad - 1`;
  * `n_node_pad = round_up(n + 1, node_pad_multiple)` always leaves one
    pad row;
  * `in_degrees` counts valid edges only;
  * the sender-sorted views `senders_perm`, `senders_sorted`,
    `receivers_by_sender` and `edge_mask_by_sender` are built on the host.

The port adds two CSR row pointers of length `n_node_pad + 1`, built on the
host: `recv_row_ptr` over the receiver-sorted edges and `send_row_ptr` over
`senders_sorted`. The padded edges are counted in the last row of each, so
every edge of the padded arrays belongs to exactly one row. The Hopper
kernels walk these rows (kernels/gin_fused.py, kernels/spmm.py).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from kagnn_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class GraphBatch:
    """A padded single graph. N = n_node_pad, E = n_edge_pad.

    Every index is in range, 0 <= idx < N, with padded edges pointing at
    the masked last row N-1."""

    senders: torch.Tensor  # (E,) int32, receiver-sorted edge order
    receivers: torch.Tensor  # (E,) int32, ascending
    nodes: Optional[torch.Tensor]  # (N, F)
    y: Optional[torch.Tensor]  # (N,) node targets
    node_mask: torch.Tensor  # (N,) bool
    edge_mask: torch.Tensor  # (E,) bool
    n_node: int
    n_edge: int
    senders_perm: torch.Tensor  # (E,) int32: senders[perm] == senders_sorted
    senders_sorted: torch.Tensor  # (E,) int32, ascending
    receivers_by_sender: torch.Tensor  # (E,) int32
    edge_mask_by_sender: torch.Tensor  # (E,) bool
    in_degrees: torch.Tensor  # (N,) int32, valid edges only
    recv_row_ptr: torch.Tensor  # (N+1,) int32 CSR over receivers
    send_row_ptr: torch.Tensor  # (N+1,) int32 CSR over senders_sorted

    @property
    def n_node_pad(self) -> int:
        return self.node_mask.shape[0]

    @property
    def n_edge_pad(self) -> int:
        return self.edge_mask.shape[0]

    @property
    def device(self) -> torch.device:
        return self.senders.device

    def to(self, device) -> "GraphBatch":
        dev = resolve_device(device)
        kw = {f.name: getattr(self, f.name) for f in dataclasses.fields(self)}
        for k, v in kw.items():
            if isinstance(v, torch.Tensor):
                kw[k] = v.to(dev)
        return GraphBatch(**kw)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _row_ptr(sorted_rows: np.ndarray, n_rows: int) -> np.ndarray:
    counts = np.bincount(sorted_rows, minlength=n_rows)
    return np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)


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
    padded `GraphBatch` on `device` (CUDA unless told otherwise)."""
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

    in_deg = np.bincount(receivers, minlength=n_pad).astype(np.int32)

    pad_e = e_pad - n_edge
    senders = np.concatenate([senders, np.full(pad_e, n_pad - 1, np.int32)])
    receivers = np.concatenate([receivers, np.full(pad_e, n_pad - 1, np.int32)])
    edge_mask = np.arange(e_pad) < n_edge
    node_mask = np.arange(n_pad) < n_node

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

    perm = np.argsort(senders, kind="stable").astype(np.int32)
    senders_sorted = senders[perm]

    def t(a):
        return None if a is None else torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    return GraphBatch(
        senders=t(senders),
        receivers=t(receivers),
        nodes=t(nodes),
        y=t(y),
        node_mask=t(node_mask),
        edge_mask=t(edge_mask),
        n_node=n_node,
        n_edge=n_edge,
        senders_perm=t(perm),
        senders_sorted=t(senders_sorted),
        receivers_by_sender=t(receivers[perm]),
        edge_mask_by_sender=t(edge_mask[perm]),
        in_degrees=t(in_deg),
        recv_row_ptr=t(_row_ptr(receivers, n_pad)),
        send_row_ptr=t(_row_ptr(senders_sorted, n_pad)),
    )
