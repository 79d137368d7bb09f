"""Reference-named convenience constructors, the counterparts of
`kagnn_tpu/nn/kagnn.py`.

Users coming from the reference find its class and helper names here
(node_classification_clean/models.py:8-92); each is a thin alias over the
compositional core (`nn/convs.py` with `kan_transform` /
`fastkan_transform`, `kan/layers.py`, `nn/mlp.py`). `fused` goes to the
conv and to its layers, as the port's models pass it; `kw` (generator,
device, compute_dtype) to the layers, and the device to a conv's own
parameters.
"""
from __future__ import annotations

from torch import nn

from kagnn_tpu_torch.kan.layers import KAN, FastKAN
from kagnn_tpu_torch.nn.convs import (GATConv, GCNConv, GINConv, GINEConv,
                                      fastkan_transform, kan_transform)
from kagnn_tpu_torch.nn.mlp import MLP


def make_mlp(num_features: int, hidden_dim: int, out_dim: int,
             hidden_layers: int, batch_norm: bool = False, **kw) -> nn.Module:
    """Reference `make_mlp` (models.py:8-17 / graph models.py:9-24)."""
    return MLP(num_features, hidden_dim, out_dim, hidden_layers,
               batch_norm=batch_norm, **kw)


def _sizes(num_features: int, hidden_dim: int, out_dim: int,
           hidden_layers: int) -> list[int]:
    return [num_features] + [hidden_dim] * (hidden_layers - 1) + [out_dim]


def make_kan(num_features: int, hidden_dim: int, out_dim: int,
             hidden_layers: int, grid_size: int, spline_order: int,
             fused: bool = False, **kw) -> nn.Module:
    """Reference `make_kan` (models.py:19-21)."""
    return KAN(_sizes(num_features, hidden_dim, out_dim, hidden_layers),
               grid_size=grid_size, spline_order=spline_order, fused=fused, **kw)


def make_fastkan(num_features: int, hidden_dim: int, out_dim: int,
                 hidden_layers: int, grid_size: int, fused: bool = False,
                 **kw) -> nn.Module:
    """Reference `make_fastkan` (models.py:23-25)."""
    return FastKAN(_sizes(num_features, hidden_dim, out_dim, hidden_layers),
                   num_grids=grid_size, fused=fused, **kw)


def KAGCNConv(in_feat: int, out_feat: int, grid_size: int = 4,
              spline_order: int = 3, fused: bool = False, **kw) -> GCNConv:
    """Reference `KAGCNConv`/`KAGCN_Layer` (models.py:31-37): GCN with a
    B-spline KAN feature transform."""
    return GCNConv(in_feat, out_feat,
                   transform=kan_transform(grid_size, spline_order, fused=fused, **kw),
                   fused=fused, device=kw.get("device"))


def KAGATConv(in_feat: int, out_feat: int, heads: int, grid_size: int = 4,
              spline_order: int = 3, fused: bool = False, **kw) -> GATConv:
    """Reference `KAGATConv`/`KAGAT_Layer` (models.py:39-46)."""
    return GATConv(in_feat, out_feat, heads,
                   transform=kan_transform(grid_size, spline_order, fused=fused, **kw),
                   fused=fused, generator=kw.get("generator"), device=kw.get("device"))


def GIKANLayer(in_feat: int, out_feat: int, grid_size: int = 4,
               spline_order: int = 3, hidden_dim: int = 16,
               nb_layers: int = 2, fused: bool = False, **kw) -> GINConv:
    """Reference `GIKANLayer` (models.py:48-56): GIN with a KAN update net."""
    return GINConv(make_kan(in_feat, hidden_dim, out_feat, nb_layers,
                            grid_size, spline_order, fused, **kw), fused=fused)


def FASTKAGCNConv(in_feat: int, out_feat: int, grid_size: int = 4,
                  fused: bool = False, **kw) -> GCNConv:
    """Reference `FASTKAGCNConv`/`FASTKAGCN_Layer` (models.py:68-74)."""
    return GCNConv(in_feat, out_feat,
                   transform=fastkan_transform(grid_size, fused=fused, **kw),
                   fused=fused, device=kw.get("device"))


def FASTKAGATConv(in_feat: int, out_feat: int, heads: int,
                  grid_size: int = 4, fused: bool = False, **kw) -> GATConv:
    """Reference `FASTKAGATConv` (models.py:76-83)."""
    return GATConv(in_feat, out_feat, heads,
                   transform=fastkan_transform(grid_size, fused=fused, **kw),
                   fused=fused, generator=kw.get("generator"), device=kw.get("device"))


def GIFASTKANLayer(in_feat: int, out_feat: int, grid_size: int = 4,
                   hidden_dim: int = 16, nb_layers: int = 2,
                   fused: bool = False, **kw) -> GINConv:
    """Reference `GIFASTKANLayer` (models.py:85-92)."""
    return GINConv(make_fastkan(in_feat, hidden_dim, out_feat, nb_layers,
                                grid_size, fused, **kw), fused=fused)


def KAGINEConv(hidden_dim: int, hidden_layers: int, grid_size: int = 4,
               spline_order: int = 3, fused: bool = False, **kw) -> GINEConv:
    """GINE with a KAN update net (reference graph_regression/models.py:96-99)."""
    return GINEConv(make_kan(hidden_dim, hidden_dim, hidden_dim, hidden_layers,
                             grid_size, spline_order, fused, **kw), fused=fused)
