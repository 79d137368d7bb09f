"""Segment ops, the counterparts of `kagnn_tpu/ops/segment.py`
`neighbor_sum`, `gather` and `gcn_aggregate`. `neighbor_sum` and `gather`
are plain PyTorch on any device; the fused GIN paths aggregate inside their
kernels instead (kernels/gin_fused.py, kernels/gin_fastkan.py), and
`gcn_aggregate(fused=True)` runs kernels/gcn_agg.py."""
from __future__ import annotations

from typing import Optional

import torch

from kagnn_tpu_torch.kernels.gcn_agg import gcn_aggregate_fused


def gather(x: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """Row gather x[indices]; indices are in range by the batcher's
    invariant."""
    return x.index_select(0, indices.long())


def neighbor_sum(x: torch.Tensor, g, edge_weight: Optional[torch.Tensor] = None
                 ) -> torch.Tensor:
    """out_i = sum over edges e with receiver i of w_e * x[sender_e]. The
    edge weight is not differentiated (the JAX op stops its gradient)."""
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
