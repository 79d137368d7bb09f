"""Plain segment ops, the counterparts of `kagnn_tpu/ops/segment.py`
`neighbor_sum` and `gather` on the unfused path. They are plain PyTorch on
any device; the fused path aggregates inside the GIN kernel instead
(kernels/gin_fused.py)."""
from __future__ import annotations

from typing import Optional

import torch


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
