"""Graph-classification model, the counterpart of
`kagnn_tpu/models/graph.py::GraphClassifier` for conv_type in {"gin",
"gcn", "gat"} and architecture in {"mlp", "kan", "fastkan"} (the
reference's nine graph-classification classes).

  * GIN: GINConv with a same-family update net of depth `hidden_layers`
    (an MLP with its own BatchNorm, a KAN or a FastKAN); the KAN and
    FastKAN variants add an external MaskedBatchNorm after each conv;
    dropout; global_add_pool; a same-family head of depth `hidden_layers`.
  * GCN: conv -> SiLU -> dropout; global_mean_pool; a one-layer head (a
    one-layer MLP is Linear -> ReLU, the reference's quirk).
  * GAT: conv -> SiLU -> dropout; global_add_pool over hidden_dim * heads;
    a one-layer head.

The head's output is cast to f32, then log_softmax. Under a compute dtype
floating node features are cast on entry, as in the JAX model. Submodules:
`convs.{i}`, `norms.{i}` (GIN with KAN or FastKAN), `head`. With `fused`
the convs run their kernels and the pools the segment-sum kernel over
`graph_row_ptr`.
"""
from __future__ import annotations

import functools
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from kagnn_tpu_torch.kan.layers import KAN, FastKAN
from kagnn_tpu_torch.nn.convs import (GATConv, GCNConv, GINConv,
                                      dense_transform, fastkan_transform,
                                      global_add_pool, global_mean_pool,
                                      kan_transform)
from kagnn_tpu_torch.models.node import NodeClassifier
from kagnn_tpu_torch.nn.mlp import MLP
from kagnn_tpu_torch.ops.norm import MaskedBatchNorm
from kagnn_tpu_torch.utils.device import resolve_device


class GraphFamily(nn.Module):
    """What the graph models share: the family's transform factory and
    net maker, and dropout from the model's explicit generator."""

    def _family(self, architecture: str, hidden_dim: int, grid_size: int,
                spline_order: int, fused: bool, compute_dtype, gen, dev):
        if architecture not in ("mlp", "kan", "fastkan"):
            raise ValueError(f"unknown architecture {architecture!r}")
        kw = dict(fused=fused, compute_dtype=compute_dtype, generator=gen,
                  device=dev)
        if architecture == "kan":
            basis = dict(grid_size=grid_size, spline_order=spline_order, **kw)
            kan = functools.partial(KAN, **basis)
            return kan_transform(**basis), lambda sizes, bn: kan(sizes)
        if architecture == "fastkan":
            basis = dict(num_grids=grid_size, **kw)
            fast = functools.partial(FastKAN, **basis)
            return fastkan_transform(**basis), lambda sizes, bn: fast(sizes)

        def mlp(sizes, bn):
            return MLP(sizes[0], hidden_dim, sizes[-1], len(sizes) - 1,
                       batch_norm=bn, generator=gen, device=dev)
        return dense_transform(generator=gen, device=dev), mlp

    # dropout from the model's own generator, seeded seed + 1 at first use
    _drop = NodeClassifier._drop


class GraphClassifier(GraphFamily):
    def __init__(self, conv_type: str, architecture: str, gnn_layers: int,
                 num_features: int, hidden_dim: int, num_classes: int,
                 hidden_layers: int = 2, grid_size: int = 4,
                 spline_order: int = 3, dropout: float = 0.0, heads: int = 4,
                 fused: bool = False,
                 compute_dtype: Optional[torch.dtype] = None, seed: int = 0,
                 device=None):
        super().__init__()
        if conv_type not in ("gin", "gcn", "gat"):
            raise ValueError(f"unknown conv_type {conv_type!r}")
        dev = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)
        Hd = hidden_dim
        make, net = self._family(architecture, Hd, grid_size, spline_order,
                                 fused, compute_dtype, gen, dev)
        self.convs = nn.ModuleList()
        self.norms = nn.ModuleList()
        for i in range(gnn_layers):
            if conv_type == "gin":
                fin = num_features if i == 0 else Hd
                sizes = [fin] + [Hd] * (hidden_layers - 1) + [Hd]
                self.convs.append(GINConv(net(sizes, True), fused=fused))
                if architecture != "mlp":
                    self.norms.append(MaskedBatchNorm(Hd, device=dev))
            elif conv_type == "gcn":
                fin = num_features if i == 0 else Hd
                self.convs.append(GCNConv(fin, Hd, make, fused=fused, device=dev))
            else:
                fin = num_features if i == 0 else Hd * heads
                self.convs.append(GATConv(fin, Hd, heads, make, fused=fused,
                                          generator=gen, device=dev))
        if conv_type == "gin":
            head = [Hd] + [Hd] * (hidden_layers - 1) + [num_classes]
        else:
            head = [Hd * (heads if conv_type == "gat" else 1), num_classes]
        self.head = net(head, False)
        self.conv_type, self.fused = conv_type, fused
        self.dropout, self.compute_dtype, self.seed = dropout, compute_dtype, seed
        self._dropout_gen = None

    def forward(self, g, x: Optional[torch.Tensor] = None) -> torch.Tensor:
        if x is None:
            x = g.nodes
        if self.compute_dtype is not None and x.is_floating_point():
            x = x.to(self.compute_dtype)
        for i, conv in enumerate(self.convs):
            x = conv(g, x)
            if self.conv_type != "gin":
                x = F.silu(x)
            elif len(self.norms):
                x = self.norms[i](x, mask=g.node_mask)
            x = self._drop(x)
        if self.conv_type == "gcn":
            pooled = global_mean_pool(g, x, fused=self.fused)
        else:
            pooled = global_add_pool(g, x, fused=self.fused)
        out = self.head(pooled, mask=g.graph_mask, train=self.training)
        return torch.log_softmax(out.float(), dim=1)
