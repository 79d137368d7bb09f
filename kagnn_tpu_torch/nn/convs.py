"""Graph convolutions over a padded `GraphBatch`: `GINConv`, the
counterpart of `kagnn_tpu/nn/convs.py::GINConv` with a KAN update net.
GCN, GAT, GINE and MLP update nets come with later slices of the port."""
from __future__ import annotations

import torch
from torch import nn

from kagnn_tpu_torch.kan.layers import KAN


class GINConv(nn.Module):
    """update((1+eps)·x_i + sum_{j in N(i)} x_j), eps fixed (PyG default
    train_eps=False). The aggregation fuses into the KAN update net's first
    KANLinear (kernels/gin_fused.py when the net is fused)."""

    def __init__(self, update: KAN, eps: float = 0.0):
        super().__init__()
        self.update, self.eps = update, eps

    def forward(self, g, x: torch.Tensor) -> torch.Tensor:
        return self.update(x, mask=g.node_mask, train=self.training,
                           gin_graph=(g, self.eps))
