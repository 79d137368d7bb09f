"""Graph-regression model, the counterpart of
`kagnn_tpu/models/regression.py::GraphRegressor` for conv_type in {"gin",
"gcn"} and architecture in {"mlp", "kan", "fastkan"} (the reference's six
ZINC / QM9 classes).

  * encoders: `AtomEncoder` / `BondEncoder` with `ogb_encoders` (ZINC),
    else the linear `atom_encoder` / `bond_encoder` (QM9); x is cast to the
    compute dtype after its encoder, e is not (it stays f32);
  * GIN: GINEConv (messages ReLU(x_j + e_ij)) with a same-family update
    net of depth `hidden_layers`; the KAN and FastKAN variants add an
    external MaskedBatchNorm per conv; dropout; global_add_pool; a
    same-family head of depth `hidden_layers`;
  * GCN: conv -> SiLU -> dropout; global_ADD_pool (unlike the classifier's
    mean); a one-layer head.

The output is raw, cast to f32. Submodules: `atom_encoder`,
`bond_encoder` (GIN only), `convs.{i}`, `norms.{i}`, `head`.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from kagnn_tpu_torch.models.graph import GraphFamily
from kagnn_tpu_torch.nn.convs import GCNConv, GINEConv, global_add_pool
from kagnn_tpu_torch.nn.encoders import AtomEncoder, BondEncoder
from kagnn_tpu_torch.nn.mlp import TorchLinear
from kagnn_tpu_torch.ops.norm import MaskedBatchNorm
from kagnn_tpu_torch.utils.device import resolve_device


class GraphRegressor(GraphFamily):
    def __init__(self, conv_type: str, architecture: str, gnn_layers: int,
                 num_node_features: int, num_edge_features: int,
                 hidden_dim: int, num_targets: int = 1, hidden_layers: int = 2,
                 grid_size: int = 4, spline_order: int = 3,
                 dropout: float = 0.0, ogb_encoders: bool = True,
                 fused: bool = False,
                 compute_dtype: Optional[torch.dtype] = None, seed: int = 0,
                 device=None):
        super().__init__()
        if conv_type not in ("gin", "gcn"):
            raise ValueError(f"unknown conv_type {conv_type!r}")
        dev = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)
        Hd = hidden_dim
        kw = dict(generator=gen, device=dev)
        make, net = self._family(architecture, Hd, grid_size, spline_order,
                                 fused, compute_dtype, gen, dev)
        self.atom_encoder = (AtomEncoder(Hd, **kw) if ogb_encoders
                             else TorchLinear(num_node_features, Hd, **kw))
        if conv_type == "gin":
            self.bond_encoder = (BondEncoder(Hd, **kw) if ogb_encoders
                                 else TorchLinear(num_edge_features, Hd, **kw))
        self.convs = nn.ModuleList()
        self.norms = nn.ModuleList()
        for _ in range(gnn_layers):
            if conv_type == "gin":
                sizes = [Hd] * hidden_layers + [Hd]
                self.convs.append(GINEConv(net(sizes, True), fused=fused))
                if architecture != "mlp":
                    self.norms.append(MaskedBatchNorm(Hd, device=dev))
            else:
                self.convs.append(GCNConv(Hd, Hd, make, fused=fused, device=dev))
        head = ([Hd] * hidden_layers + [num_targets] if conv_type == "gin"
                else [Hd, num_targets])
        self.head = net(head, False)
        self.conv_type, self.fused = conv_type, fused
        self.dropout, self.compute_dtype, self.seed = dropout, compute_dtype, seed
        self._dropout_gen = None

    def forward(self, g, x: Optional[torch.Tensor] = None,
                edge_attr: Optional[torch.Tensor] = None) -> torch.Tensor:
        if x is None:
            x = g.nodes
        if edge_attr is None:
            edge_attr = g.edges
        x = self.atom_encoder(x)
        if self.compute_dtype is not None:
            x = x.to(self.compute_dtype)
        if self.conv_type == "gin":
            if edge_attr.dim() == 1:
                edge_attr = edge_attr[:, None]
            e = self.bond_encoder(edge_attr)
            for i, conv in enumerate(self.convs):
                x = conv(g, x, e)
                if len(self.norms):
                    x = self.norms[i](x, mask=g.node_mask)
                x = self._drop(x)
        else:
            for conv in self.convs:
                x = self._drop(F.silu(conv(g, x)))
        pooled = global_add_pool(g, x, fused=self.fused)
        out = self.head(pooled, mask=g.graph_mask, train=self.training)
        return out.float()
