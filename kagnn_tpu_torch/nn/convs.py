"""Graph convolutions over a padded `GraphBatch`, the counterparts of
`kagnn_tpu/nn/convs.py`:

  * `GINConv` — update((1+eps)·x_i + Σ_j x_j) with a KAN or FastKAN update
    net (the aggregation fuses into the net's first layer);
  * `GCNConv` — D^-1/2 (A+I) D^-1/2 · t(x) + b with the self-loops in closed
    form, the transform t from a factory (fin, fout) -> KANLinear or
    FastKANLayer.

GAT, GINE and MLP update nets come with later slices of the port."""
from __future__ import annotations

from typing import Callable

import torch
from torch import nn

from kagnn_tpu_torch.kan.layers import FastKANLayer, KANLinear
from kagnn_tpu_torch.ops import segment
from kagnn_tpu_torch.utils.device import resolve_device

TransformFactory = Callable[[int, int], nn.Module]


def kan_transform(grid_size: int = 4, spline_order: int = 3,
                  **kw) -> TransformFactory:
    """The reference's `KANLayer` adapter (grid_size default 4); `kw` goes
    to KANLinear (fused, compute_dtype, generator, device)."""
    def make(fin: int, fout: int) -> nn.Module:
        return KANLinear(fin, fout, grid_size=grid_size,
                         spline_order=spline_order, **kw)
    return make


def fastkan_transform(num_grids: int = 4, **kw) -> TransformFactory:
    """The reference's `FKANLayer` adapter; `kw` goes to FastKANLayer."""
    def make(fin: int, fout: int) -> nn.Module:
        return FastKANLayer(fin, fout, num_grids=num_grids, **kw)
    return make


class GINConv(nn.Module):
    """update((1+eps)·x_i + sum_{j in N(i)} x_j), eps fixed (PyG default
    train_eps=False). The aggregation fuses into the update net's first
    layer (kernels/gin_fused.py for KAN, kernels/gin_fastkan.py for FastKAN,
    when the net is fused)."""

    def __init__(self, update: nn.Module, eps: float = 0.0):
        super().__init__()
        self.update, self.eps = update, eps

    def forward(self, g, x: torch.Tensor) -> torch.Tensor:
        return self.update(x, mask=g.node_mask, train=self.training,
                           gin_graph=(g, self.eps))


def _degree_with_self_loops(g, dtype: torch.dtype) -> torch.Tensor:
    """d_i = 1 + #incoming valid edges, in `dtype`. As in the JAX package
    the in-degree is cast BEFORE the +1 (and the rsqrt that follows), so
    under bf16 a degree above 256 rounds."""
    return g.in_degrees.to(dtype) + 1.0


class GCNConv(nn.Module):
    """GCN layer (PyG GCNConv with add_self_loops=True, normalize=True,
    KAN-grafted transform). The symmetric norm factorises: with
    dinv = d^-1/2 and hs = t(x) * dinv, out = dinv ⊙ (A·hs + hs) + bias,
    the aggregate in one kernel when `fused` (kernels/gcn_agg.py).

    The bias is an f32 parameter: under a compute dtype it promotes the
    conv's output to f32, as in the JAX layer."""

    def __init__(self, in_features: int, out_features: int,
                 transform: TransformFactory, fused: bool = False,
                 device=None):
        super().__init__()
        self.transform = transform(in_features, out_features)
        self.fused = fused
        self.bias = nn.Parameter(torch.zeros(out_features,
                                             device=resolve_device(device)))

    def forward(self, g, x: torch.Tensor) -> torch.Tensor:
        h = self.transform(x)
        dinv = torch.rsqrt(_degree_with_self_loops(g, h.dtype))
        hs = h * dinv[:, None]
        out = segment.gcn_aggregate(hs, g, dinv, fused=self.fused)
        return out + self.bias
