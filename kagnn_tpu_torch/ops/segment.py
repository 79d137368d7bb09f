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
kernel (kernels/gin_fused.py)."""
from __future__ import annotations

from typing import Optional

import torch

from kagnn_tpu_torch.kernels._common import leaky
from kagnn_tpu_torch.kernels.gat_fused import gat_attention_fused
from kagnn_tpu_torch.kernels.gcn_agg import gcn_aggregate_fused
from kagnn_tpu_torch.kernels.spmm import SortedSegmentSum, sorted_segment_sum

NEG = -1e30  # the logit of a masked edge, and the floor of an empty max


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
    jax.ops.segment_sum."""
    if fused and _kernel_eligible(data):
        if row_ptr is None:
            raise ValueError("the fused segment sum walks a row pointer")
        return SortedSegmentSum.apply(data.contiguous(), row_ptr, segment_ids)
    out = torch.zeros((num_segments,) + tuple(data.shape[1:]), dtype=data.dtype,
                      device=data.device)
    return out.index_add(0, segment_ids.long(), data)


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
    for 2-D f32/bf16 x (its backward on the segment-sum kernel)."""
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
    mask weight unnecessary."""
    if fused:
        if edge_weight is not None:
            raise ValueError("the fused neighbor sum takes no edge weight")
        return NeighborSum.apply(x.contiguous(), g)
    msgs = gather(x, g.senders)
    if edge_weight is not None:
        msgs = msgs * edge_weight.detach()[:, None]
    out = torch.zeros((g.n_node_pad,) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    return out.index_add(0, g.receivers.long(), msgs)


def gcn_aggregate(hs: torch.Tensor, g, dinv: torch.Tensor,
                  fused: bool = False) -> torch.Tensor:
    """GCN epilogue `dinv ⊙ (A @ hs + hs)`: the aggregate with the
    self-loop term and the receiver-side norm folded in (`hs` already
    carries the sender-side norm, hs = h * dinv). dinv gets no gradient.
    `fused` always runs the gcn_agg kernel, which takes f32 and bf16 and
    raises for any other dtype on the card; the plain path computes in hs's
    dtype, as the JAX fallback does."""
    dinv = dinv.detach()
    if fused:
        return gcn_aggregate_fused(hs, g, dinv)
    return (neighbor_sum(hs, g) + hs) * dinv[:, None].to(hs.dtype)


def _rows(v: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """(E,) -> (E, 1, ...) to broadcast against `like`."""
    return v.reshape(v.shape + (1,) * (like.dim() - 1))


def segment_max(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """Max of `data` rows per segment; an empty segment gives -inf (the
    identity of max, as jax.ops.segment_max)."""
    out = torch.full((num_segments,) + tuple(data.shape[1:]), float("-inf"),
                     dtype=data.dtype, device=data.device)
    idx = _rows(segment_ids.long(), data).expand_as(data)
    return out.scatter_reduce(0, idx, data, "amax", include_self=True)


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
    denom = torch.zeros_like(seg_max).index_add(0, seg, edge_exp)
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
    same gradients without a scatter)."""
    w2 = edge_weight if edge_weight.dim() == 2 else edge_weight[:, None]
    e, heads = w2.shape
    msgs = gather(x, g.senders)
    msgs = (msgs.reshape(e, heads, -1) * w2[:, :, None]).reshape(e, -1)
    out = torch.zeros((g.n_node_pad, msgs.shape[1]), dtype=msgs.dtype,
                      device=msgs.device)
    return out.index_add(0, g.receivers.long(), msgs)


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
    (segment_softmax + neighbor_sum_attn) and ignores it."""
    if fused:
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
