"""Segment ops, the counterparts of `kagnn_tpu/ops/segment.py`:
`gather`, `neighbor_sum`, `gcn_aggregate`, and GAT's `segment_max`,
`segment_softmax`, `neighbor_sum_attn` and `gat_attention`.

The plain versions are PyTorch on any device (autograd gives their VJPs).
`neighbor_sum(fused=True)` runs the segment-sum kernel forward and
backward (kernels/spmm.py), `gcn_aggregate(fused=True)` the gcn_agg kernel
and `gat_attention(fused=True)` the three GAT kernels
(kernels/gat_fused.py); the fused GIN+KAN path aggregates inside its own
kernel (kernels/gin_fused.py)."""
from __future__ import annotations

from typing import Optional

import torch

from kagnn_tpu_torch.kernels._common import leaky
from kagnn_tpu_torch.kernels.gat_fused import gat_attention_fused
from kagnn_tpu_torch.kernels.gcn_agg import gcn_aggregate_fused
from kagnn_tpu_torch.kernels.spmm import sorted_segment_sum

NEG = -1e30  # the logit of a masked edge, and the floor of an empty max


def gather(x: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """Row gather x[indices]; indices are in range by the batcher's
    invariant."""
    return x.index_select(0, indices.long())


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
