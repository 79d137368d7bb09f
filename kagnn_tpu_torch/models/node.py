"""Node-classification model, the counterpart of
`kagnn_tpu/models/node.py::NodeClassifier` for conv_type in {"gin", "gcn",
"gat"} and architecture in {"mlp", "kan", "fastkan"} (the reference's
GNN_Nodes, GKAN_Nodes and GFASTKAN_Nodes).

Per message-passing layer: conv -> MaskedBatchNorm -> dropout; the head is
a TorchLinear (mlp), a KANLinear (kan) or a FastKANLayer (fastkan, with
num_grids = grid_size). With mlp the GIN update is `MLP(fin, H, H,
hidden_layers)` without BatchNorm and the GCN and GAT transforms are
`dense_transform`'s bias-free Glorot linear; their f32 weights promote a
bf16 input to f32, so under bf16 these paths are f32 from the first dense
product on, as the JAX model's are;
with `skip` the head reads the concatenation [x0, h1, ..., hL]. `heads`
applies to GAT only (the other convs have one): a GAT conv outputs
hidden_channels * heads features, which the next conv, the BatchNorm and
the head take.
Under a compute dtype the node features are cast on entry and the logits
come back in f32, as in the JAX model.
"""
from __future__ import annotations

import functools
from typing import Optional

import torch
from torch import nn

from kagnn_tpu_torch.kan.layers import KAN, FastKAN, FastKANLayer, KANLinear
from kagnn_tpu_torch.nn.convs import (GATConv, GCNConv, GINConv,
                                      dense_transform, fastkan_transform,
                                      kan_transform)
from kagnn_tpu_torch.nn.mlp import MLP, TorchLinear
from kagnn_tpu_torch.ops.norm import MaskedBatchNorm
from kagnn_tpu_torch.utils.device import resolve_device


class NodeClassifier(nn.Module):
    def __init__(self, conv_type: str, architecture: str, mp_layers: int,
                 num_features: int, hidden_channels: int, num_classes: int,
                 skip: bool = True, grid_size: int = 4, spline_order: int = 3,
                 hidden_layers: int = 2, dropout: float = 0.0, heads: int = 4,
                 fused: bool = False,
                 compute_dtype: Optional[torch.dtype] = None, seed: int = 0,
                 device=None):
        super().__init__()
        if (conv_type not in ("gin", "gcn", "gat")
                or architecture not in ("mlp", "kan", "fastkan")):
            raise ValueError(f"unknown conv_type/architecture "
                             f"{conv_type!r}/{architecture!r}")
        heads = heads if conv_type == "gat" else 1
        dev = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)
        H = hidden_channels
        kw = dict(fused=fused, compute_dtype=compute_dtype, generator=gen,
                  device=dev)
        if architecture == "kan":
            basis = dict(grid_size=grid_size, spline_order=spline_order, **kw)
            make, layer = kan_transform(**basis), KANLinear
            net = functools.partial(KAN, **basis)
        elif architecture == "fastkan":
            basis = dict(num_grids=grid_size, **kw)
            make, layer = fastkan_transform(**basis), FastKANLayer
            net = functools.partial(FastKAN, **basis)
        else:
            basis = dict(generator=gen, device=dev)
            make, layer = dense_transform(**basis), TorchLinear
            # the reference's node make_mlp: no BatchNorm
            net = lambda sizes: MLP(sizes[0], H, sizes[-1], hidden_layers,  # noqa: E731
                                    **basis)
        self.convs = nn.ModuleList()
        self.norms = nn.ModuleList()
        for i in range(mp_layers):
            fin = num_features if i == 0 else H * heads
            if conv_type == "gcn":
                self.convs.append(GCNConv(fin, H, make, fused=fused, device=dev))
            elif conv_type == "gat":
                self.convs.append(GATConv(fin, H, heads, make, fused=fused,
                                          generator=gen, device=dev))
            else:
                sizes = [fin] + [H] * (hidden_layers - 1) + [H]
                self.convs.append(GINConv(net(sizes), fused=fused))
            self.norms.append(MaskedBatchNorm(H * heads, device=dev))
        self.skip, self.dropout = skip, dropout
        self.compute_dtype, self.seed = compute_dtype, seed
        dim_head = num_features + mp_layers * H * heads if skip else H * heads
        self.head = layer(dim_head, num_classes, **basis)
        self._dropout_gen = None

    def _drop(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.dropout == 0.0:
            return x
        if self._dropout_gen is None:
            self._dropout_gen = torch.Generator(device=x.device).manual_seed(
                self.seed + 1)
        keep = torch.rand(x.shape, generator=self._dropout_gen,
                          device=x.device) >= self.dropout
        return x * keep.to(x.dtype) / (1.0 - self.dropout)

    def forward(self, g, x: Optional[torch.Tensor] = None) -> torch.Tensor:
        if x is None:
            x = g.nodes
        if self.compute_dtype is not None:
            x = x.to(self.compute_dtype)
        collected = [x]
        for conv, norm in zip(self.convs, self.norms):
            x = conv(g, x)
            x = norm(x, mask=g.node_mask)
            x = self._drop(x)
            collected.append(x)
        if self.skip:
            x = torch.cat(collected, dim=1)
        return self.head(x).float()
