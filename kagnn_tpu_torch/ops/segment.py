"""Segment ops, the counterparts of `kagnn_tpu/ops/segment.py`:
`gather`, `sender_gather`, `segment_sum`, `segment_mean`, `neighbor_sum`,
`gcn_aggregate`, and GAT's `segment_max`, `segment_softmax`,
`neighbor_sum_attn` and `gat_attention`.

The plain versions are PyTorch on any device (autograd gives their VJPs).
`neighbor_sum(fused=True)` runs the segment-sum kernel forward and
backward (kernels/spmm.py), `segment_sum(fused=True)` forward (the pools
and GINE's aggregate) and `sender_gather(fused=True)` backward (GINE's
gradient to x), `gcn_aggregate(fused=True)` the gcn_agg kernel
and `gat_attention(fused=True)` the three GAT kernels
(kernels/gat_fused.py); the fused GIN+KAN path aggregates inside its own
kernel (kernels/gin_fused.py).

Two distribution modes, the JAX module's, switch these ops on:

  * `edge_axis(group)` (the edge partition, dist/partition.py): every rank
    holds a shard of the edges and all the node rows, so each edge->node
    reduction ends with the matching all-reduce over `group` (SUM for
    `segment_sum`, MAX for `segment_max`), and no fused GCN or GAT kernel
    runs;
  * `halo_mode(state)` (the halo-exchange node partition, dist/halo.py):
    every rank holds a block of B node rows and the edges into them, with
    senders in the extended space [local; halo] of B + D*H rows; the
    boundary rows come from their owners in one `all_to_all_single`
    (`halo_exchange`), and `neighbor_sum`, `neighbor_sum_attn`,
    `sender_gather` and the convs aggregate locally.

The collectives are autograd Functions. The all-reduce's backward is the
all-reduce SUM of the cotangents, the transpose of the JAX package's psum
under its halo step (`shard_map(check_vma=False)`): every rank's loss is the
global one, so each cotangent that passes a collective is the sum of the D
ranks' and the steps average the gradients over the ranks (dist/halo.py,
dist/partition.py). The exchange's backward is its exact transpose: the
reverse all_to_all, then the received cotangents added into the sent rows
(a row may go to several peers). Both backends take the tensors where they
are, on the card or on the CPU (gloo copies card tensors to the host
itself)."""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Optional

import torch
import torch.distributed as dist

from kagnn_tpu_torch.kernels._common import leaky
from kagnn_tpu_torch.kernels.gat_fused import gat_attention_fused
from kagnn_tpu_torch.kernels.gcn_agg import gcn_aggregate_fused
from kagnn_tpu_torch.kernels.spmm import SortedSegmentSum, sorted_segment_sum

NEG = -1e30  # the logit of a masked edge, and the floor of an empty max

_STATE = threading.local()


# --- collectives ------------------------------------------------------------

def all_reduce(t: torch.Tensor, op=dist.ReduceOp.SUM, group=None) -> torch.Tensor:
    """The all-reduce of t over `group`, out of place and not
    differentiated."""
    buf = t.detach().clone().contiguous()
    dist.all_reduce(buf, op=op, group=group)
    return buf


class AllReduceSum(torch.autograd.Function):
    """The all-reduce SUM over `group`; its backward all-reduces the
    cotangents (the psum transpose of the JAX halo step)."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return all_reduce(t, dist.ReduceOp.SUM, group)

    @staticmethod
    def backward(ctx, cot):
        return all_reduce(cot, dist.ReduceOp.SUM, ctx.group), None


def all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    return AllReduceSum.apply(t, group)


def _all_to_all(send: torch.Tensor, group) -> torch.Tensor:
    """all_to_all_single of equal row blocks, rank p's block to rank p."""
    send = send.contiguous()
    out = torch.empty_like(send)
    dist.all_to_all_single(out, send, group=group)
    return out


# --- edge-partition collective mode ------------------------------------------

@contextlib.contextmanager
def edge_axis(group):
    """Arm every edge->node reduction with the all-reduce over `group` (a
    process group, dist.group.WORLD for the default one; None switches the
    mode off, as the pools do)."""
    prev = getattr(_STATE, "axis", None)
    _STATE.axis = group
    try:
        yield
    finally:
        _STATE.axis = prev


def current_edge_axis():
    """The group edges are partitioned over (inside `edge_axis`), or None.
    A per-node reduction computed from the local edge shard by other means
    than `segment_sum` must all-reduce its result over it."""
    return getattr(_STATE, "axis", None)


# --- halo-exchange node partition ---------------------------------------------

@dataclasses.dataclass(frozen=True)
class HaloState:
    """One rank's halo-exchange arrays: its slices of the HaloPlan
    (dist/halo.py) on its device. The port adds the row pointers of the
    internal and halo edge lists (B+1, over their valid prefixes), which the
    segment-sum kernel walks."""

    axis: object                   # the process group node blocks are sharded over
    n_local: int                   # B, rows of a node shard
    send_idx: torch.Tensor         # (D, H) int64: local rows to send to peer p
    send_mask: torch.Tensor        # (D, H) bool
    dinv_ext: Optional[torch.Tensor] = None  # (B + D*H,) f32, (deg+1)^-1/2 in ext space
    s_int: Optional[torch.Tensor] = None     # (Ei,) local sender rows
    r_int: Optional[torch.Tensor] = None     # (Ei,) local receiver rows (ascending)
    int_sel: Optional[torch.Tensor] = None   # (Ei,) index into the full edge list
    int_mask: Optional[torch.Tensor] = None  # (Ei,) bool
    s_halo: Optional[torch.Tensor] = None    # (Eh,) rows of the received table (D*H)
    r_halo: Optional[torch.Tensor] = None    # (Eh,) local receiver rows (ascending)
    halo_sel: Optional[torch.Tensor] = None  # (Eh,) index into the full edge list
    halo_mask: Optional[torch.Tensor] = None  # (Eh,) bool
    int_row_ptr: Optional[torch.Tensor] = None   # (B+1,) int32 CSR of r_int's valid prefix
    halo_row_ptr: Optional[torch.Tensor] = None  # (B+1,) int32 CSR of r_halo's valid prefix


@contextlib.contextmanager
def halo_mode(state: HaloState):
    prev = getattr(_STATE, "halo", None)
    _STATE.halo = state
    try:
        yield
    finally:
        _STATE.halo = prev


def halo_state() -> Optional[HaloState]:
    return getattr(_STATE, "halo", None)


def node_stats_axis():
    """The group node rows are sharded over (for the cross-shard BatchNorm
    and loss statistics), or None outside halo mode."""
    hs = halo_state()
    return hs.axis if hs is not None else None


class HaloExchange(torch.autograd.Function):
    """The boundary rows of the local shard x (B, F): send row p*H + j is
    x[send_idx[p, j]] (zero where send_mask is off), one all_to_all_single
    over the group, and recv row p*H + j is peer p's j-th boundary row for
    this rank. The backward sends the cotangents back the same way and adds
    them into the sent rows."""

    @staticmethod
    def forward(ctx, x, send_idx, send_mask, group):
        idx, keep = send_idx.reshape(-1), send_mask.reshape(-1, 1)
        ctx.save_for_backward(idx, keep)
        ctx.group, ctx.rows = group, x.shape[0]
        zero = torch.zeros((), dtype=x.dtype, device=x.device)
        send = torch.where(keep, x.index_select(0, idx), zero)
        return _all_to_all(send, group)

    @staticmethod
    def backward(ctx, cot):
        idx, keep = ctx.saved_tensors
        back = _all_to_all(cot.contiguous(), ctx.group)
        back = torch.where(keep, back, torch.zeros((), dtype=back.dtype,
                                                   device=back.device))
        dx = torch.zeros((ctx.rows,) + tuple(back.shape[1:]), dtype=back.dtype,
                         device=back.device)
        return dx.index_add_(0, idx, back), None, None, None


def halo_exchange(x: torch.Tensor) -> torch.Tensor:
    """The local shard x (B, F) -> the received boundary rows (D*H, F)."""
    hs = halo_state()
    return HaloExchange.apply(x.contiguous(), hs.send_idx, hs.send_mask, hs.axis)


def halo_extend(x: torch.Tensor) -> torch.Tensor:
    """The local shard (B, F) -> the extended table (B + D*H, F) =
    [local; halo]."""
    return torch.cat([x, halo_exchange(x)], dim=0)


def gather(x: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """Row gather x[indices]; indices are in range by the batcher's
    invariant."""
    return x.index_select(0, indices.long())


def _kernel_eligible(data: torch.Tensor) -> bool:
    """The segment-sum kernel takes 2-D f32 or bf16 rows of any width (the
    JAX package's `shape[1] >= 64` gate is a TPU tuning choice)."""
    return data.dim() == 2 and data.dtype in (torch.float32, torch.bfloat16)


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int, row_ptr: Optional[torch.Tensor] = None,
                fused: bool = False) -> torch.Tensor:
    """Sum `data` rows into `num_segments` buckets given by ascending
    `segment_ids`. With `fused`, 2-D f32/bf16 data runs through
    `SortedSegmentSum` over `row_ptr` (num_segments+1, int32, the CSR of
    segment_ids: graph_row_ptr for the pools, recv_row_ptr for GINE), an
    f32 sum rounded once to data's dtype, as the JAX sorted segment sum
    under `use_pallas_spmm`; its backward is the gather of the cotangent at
    segment_ids (int32 or int64). Otherwise (and for any other data, such
    as segment_mean's 1-D count) an index_add in data's dtype, as
    jax.ops.segment_sum. Under `edge_axis` the sum ends with the all-reduce
    over the group."""
    if fused and _kernel_eligible(data):
        if row_ptr is None:
            raise ValueError("the fused segment sum walks a row pointer")
        out = SortedSegmentSum.apply(data.contiguous(), row_ptr, segment_ids)
    else:
        out = torch.zeros((num_segments,) + tuple(data.shape[1:]),
                          dtype=data.dtype, device=data.device)
        out = out.index_add(0, segment_ids.long(), data)
    axis = current_edge_axis()
    return out if axis is None else all_reduce_sum(out, axis)


def segment_mean(data: torch.Tensor, segment_ids: torch.Tensor,
                 num_segments: int, mask: Optional[torch.Tensor] = None,
                 row_ptr: Optional[torch.Tensor] = None,
                 fused: bool = False) -> torch.Tensor:
    """Mean per segment; `mask` (bool, per row) takes padded rows out of
    both the sum and the count. The sum as `segment_sum`, the count (1-D,
    in data's dtype) plain, floored at 1."""
    if mask is not None:
        data = torch.where(_rows(mask, data), data,
                           torch.zeros((), dtype=data.dtype, device=data.device))
        ones = mask.to(data.dtype)
    else:
        ones = torch.ones(data.shape[0], dtype=data.dtype, device=data.device)
    total = segment_sum(data, segment_ids, num_segments, row_ptr, fused)
    count = segment_sum(ones, segment_ids, num_segments)
    return total / _rows(count.clamp_min(1.0), total)


class SenderGather(torch.autograd.Function):
    """x[senders] whose backward, the segment sum of the per-edge cotangent
    over senders, runs the segment-sum kernel over the sender CSR
    (send_row_ptr, gather index senders_perm): an f32 sum rounded once to
    x's dtype, deterministic, where the JAX gather's transpose is XLA's
    scatter-add (the values agree, not the method)."""

    @staticmethod
    def forward(ctx, x, g):
        ctx.g = g
        return gather(x, g.senders)

    @staticmethod
    def backward(ctx, cot):
        g = ctx.g
        return sorted_segment_sum(cot.contiguous(), g.send_row_ptr,
                                  g.senders_perm), None


def sender_gather(x: torch.Tensor, g, fused: bool = False) -> torch.Tensor:
    """x[g.senders], the per-edge sender rows; `fused` runs `SenderGather`
    for 2-D f32/bf16 x (its backward on the segment-sum kernel). Under
    `halo_mode` the senders index the extended table, so the boundary rows
    are exchanged first (autograd carries the gradient back)."""
    if halo_state() is not None:
        return gather(halo_extend(x), g.senders)
    if fused and _kernel_eligible(x):
        return SenderGather.apply(x.contiguous(), g)
    return gather(x, g.senders)


class NeighborSum(torch.autograd.Function):
    """The JAX `_neighbor_sum_sorted` custom VJP on the segment-sum kernel:
    the forward sums x[senders] over the receiver CSR, the backward Aᵀ·cot
    over the sender CSR with the gather index `receivers_by_sender`, both
    with an f32 sum and one rounding to the input's dtype, so no (E, D)
    tensor is formed.

    There is no edge-mask weight: padded edges point at the pad row
    n_pad - 1, which is zero at every layer (layer 0 has zero pad features
    and MaskedBatchNorm zeroes masked rows), so they add zeros to the pad
    row and their backward terms only reach the pad row of dx, whose
    cotangent is zero. The JAX op's mask weight multiplies nothing that
    matters there (the quirk the fused GIN+KAN kernel has too)."""

    @staticmethod
    def forward(ctx, x, g):
        ctx.g = g
        return sorted_segment_sum(x, g.recv_row_ptr, g.senders)

    @staticmethod
    def backward(ctx, cot):
        g = ctx.g
        return sorted_segment_sum(cot.contiguous(), g.send_row_ptr,
                                  g.receivers_by_sender), None


def neighbor_sum(x: torch.Tensor, g, edge_weight: Optional[torch.Tensor] = None,
                 fused: bool = False) -> torch.Tensor:
    """out_i = sum over edges e with receiver i of w_e * x[sender_e]. The
    edge weight is not differentiated (the JAX op stops its gradient).
    `fused` runs `NeighborSum` (the segment-sum kernel both ways), which
    takes no edge weight: see its docstring for why the pad rows make the
    mask weight unnecessary. Under `edge_axis` the sum is all-reduced, under
    `halo_mode` it is `_halo_neighbor_sum`."""
    hs = halo_state()
    if hs is not None:
        return _halo_neighbor_sum(x, g, edge_weight, hs, fused)
    if fused:
        if edge_weight is not None:
            raise ValueError("the fused neighbor sum takes no edge weight")
        out = NeighborSum.apply(x.contiguous(), g)
        axis = current_edge_axis()
        return out if axis is None else all_reduce_sum(out, axis)
    msgs = gather(x, g.senders)
    if edge_weight is not None:
        msgs = msgs * edge_weight.detach()[:, None]
    return segment_sum(msgs, g.receivers, g.n_node_pad)


def _halo_neighbor_sum(x: torch.Tensor, g, edge_weight, hs: HaloState,
                       fused: bool) -> torch.Tensor:
    """The node-sharded neighbor sum (JAX `_halo_neighbor_sum`): with the
    plan's internal/halo edge split, the internal edges' sum over the local
    rows needs nothing of the exchange, then the halo edges' sum over the
    received rows; without it, one sum over the extended table. Each sum is
    the weighted messages summed per receiver, by the segment-sum kernel
    over the valid prefix's row pointer when `fused` (its padded entries,
    weight 0, are left out), else an index_add."""
    B = hs.n_local
    w = (edge_weight if edge_weight is not None
         else g.edge_mask.to(x.dtype)).detach()
    if hs.s_int is not None:
        w_int = w[hs.int_sel] * hs.int_mask.to(w.dtype)
        msgs = gather(x, hs.s_int) * w_int[:, None]
        out = segment_sum(msgs, hs.r_int, B, hs.int_row_ptr, fused)
        recv = halo_exchange(x)
        w_h = w[hs.halo_sel] * hs.halo_mask.to(w.dtype)
        msgs = gather(recv, hs.s_halo) * w_h[:, None]
        return out + segment_sum(msgs, hs.r_halo, B, hs.halo_row_ptr, fused)
    msgs = gather(halo_extend(x), g.senders) * w[:, None]
    return segment_sum(msgs, g.receivers, B, g.recv_row_ptr, fused)


def gcn_aggregate(hs: torch.Tensor, g, dinv: torch.Tensor,
                  fused: bool = False) -> torch.Tensor:
    """GCN epilogue `dinv ⊙ (A @ hs + hs)`: the aggregate with the
    self-loop term and the receiver-side norm folded in (`hs` already
    carries the sender-side norm, hs = h * dinv). dinv gets no gradient.
    `fused` always runs the gcn_agg kernel, which takes f32 and bf16 and
    raises for any other dtype on the card; the plain path computes in hs's
    dtype, as the JAX fallback does. Under `edge_axis` no fused kernel runs,
    as in the JAX package: the aggregate is the all-reduced neighbor sum
    (through the segment-sum kernel on the shard when `fused`)."""
    dinv = dinv.detach()
    if fused and current_edge_axis() is None:
        return gcn_aggregate_fused(hs, g, dinv)
    return (neighbor_sum(hs, g, fused=fused) + hs) * dinv[:, None].to(hs.dtype)


def _rows(v: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """(E,) -> (E, 1, ...) to broadcast against `like`."""
    return v.reshape(v.shape + (1,) * (like.dim() - 1))


def segment_max(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """Max of `data` rows per segment; an empty segment gives -inf (the
    identity of max, as jax.ops.segment_max). Under `edge_axis` it ends with
    the all-reduce MAX (not differentiated: the softmax's shift is a
    stop-gradient)."""
    out = torch.full((num_segments,) + tuple(data.shape[1:]), float("-inf"),
                     dtype=data.dtype, device=data.device)
    idx = _rows(segment_ids.long(), data).expand_as(data)
    out = out.scatter_reduce(0, idx, data, "amax", include_self=True)
    axis = current_edge_axis()
    return out if axis is None else all_reduce(out, dist.ReduceOp.MAX, axis)


def segment_softmax(logits: torch.Tensor, segment_ids: torch.Tensor,
                    num_segments: int, mask: Optional[torch.Tensor] = None,
                    extra_logits: Optional[torch.Tensor] = None):
    """Per-segment softmax of GAT's edge logits (JAX `segment_softmax`):
    masked edges get the logit -1e30 and weight 0, the max is a
    stop-gradient shift floored at -1e30 for empty segments, `extra_logits`
    (num_segments, ...) joins each segment's softmax (the implicit
    self-loop), and the denominator is floored at 1e-16. Returns
    (edge_weights, extra_weights); the latter are zeros without
    `extra_logits`."""
    seg = segment_ids.long()
    neg = torch.tensor(NEG, dtype=logits.dtype, device=logits.device)
    masked = logits if mask is None else torch.where(
        _rows(mask, logits), logits, neg)
    seg_max = torch.maximum(segment_max(masked.detach(), seg, num_segments), neg)
    if extra_logits is not None:
        seg_max = torch.maximum(seg_max, extra_logits)
    edge_exp = torch.exp(masked - seg_max[seg])
    if mask is not None:
        edge_exp = torch.where(_rows(mask, logits), edge_exp,
                               torch.zeros((), dtype=edge_exp.dtype,
                                           device=edge_exp.device))
    denom = segment_sum(edge_exp, seg, num_segments)
    if extra_logits is None:
        denom = torch.clamp_min(denom, 1e-16)
        return edge_exp / denom[seg], torch.zeros_like(seg_max)
    extra_exp = torch.exp(extra_logits - seg_max)
    denom = torch.clamp_min(denom + extra_exp, 1e-16)
    return edge_exp / denom[seg], extra_exp / denom


def neighbor_sum_attn(x: torch.Tensor, g, edge_weight: torch.Tensor
                      ) -> torch.Tensor:
    """out_i = sum over edges e with receiver i of w_e[h] * x[sender_e] in
    head blocks: x (N, H*C), edge_weight (E, H) or (E,). Differentiable in
    x and in the weights (autograd; the JAX op's custom VJP computes the
    same gradients without a scatter). Under `halo_mode` x is the extended
    table (GATConv exchanges h once) and the sum goes into the local rows."""
    w2 = edge_weight if edge_weight.dim() == 2 else edge_weight[:, None]
    e, heads = w2.shape
    msgs = gather(x, g.senders)
    msgs = (msgs.reshape(e, heads, -1) * w2[:, :, None]).reshape(e, -1)
    hs = halo_state()
    return segment_sum(msgs, g.receivers,
                       g.n_node_pad if hs is None else hs.n_local)


def gat_attention(h: torch.Tensor, asrc: torch.Tensor, adst: torch.Tensor,
                  g, negative_slope: float = 0.2,
                  att_src_matrix: Optional[torch.Tensor] = None,
                  fused: bool = False) -> torch.Tensor:
    """The GAT attention block: per-edge logits leaky(asrc[j] + adst[i]),
    the per-destination softmax with the implicit self-loop, and the
    weighted aggregate plus the self term. h (N, H*C), asrc/adst (N, H);
    returns (N, H*C).

    `fused` runs the GAT kernels (kernels/gat_fused.py) with their custom
    VJP; `att_src_matrix` then only says whether asrc is h's own product
    (as GATConv passes it) or a free-standing input, which the JAX kernel
    rounds to h's dtype. The plain path is the JAX fallback's composition
    (segment_softmax + neighbor_sum_attn) and ignores it; it is the path
    under `edge_axis`, where no fused kernel runs."""
    if fused and current_edge_axis() is None:
        return gat_attention_fused(h, asrc, adst, g, negative_slope,
                                   att_src_matrix=att_src_matrix)
    heads = asrc.shape[1]
    logits = gather(asrc, g.senders) + gather(adst, g.receivers)
    logits = leaky(logits, negative_slope)
    self_logits = leaky(asrc + adst, negative_slope)
    w_edge, w_self = segment_softmax(logits, g.receivers, g.n_node_pad,
                                     mask=g.edge_mask,
                                     extra_logits=self_logits)
    out = neighbor_sum_attn(h, g, w_edge)
    n, c = h.shape[0], h.shape[1] // heads
    out = (out.reshape(n, heads, c)
           + h.reshape(n, heads, c) * w_self[..., None])
    return out.reshape(n, heads * c)
