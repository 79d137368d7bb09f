"""B-spline Kolmogorov–Arnold layers, the counterparts of
`kagnn_tpu/kan/layers.py::KANLinear` and `KAN` (efficient-kan semantics).

Parameters keep the reference torch names and layouts: `base_weight`
(out, in), `spline_weight` (out, in, grid+order), `spline_scaler`
(out, in) and the knot buffer `grid` (in, grid + 2*order + 1).

Under a compute dtype the input, the knot grid and both weights are cast to
it where the JAX layer casts them (`layers.py:121-123`); the parameters stay
f32 master weights.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from kagnn_tpu_torch.kan import bspline
from kagnn_tpu_torch.kernels.bspline_fused import kan_linear_fused
from kagnn_tpu_torch.kernels.gin_fused import gin_kan_fused
from kagnn_tpu_torch.ops import segment
from kagnn_tpu_torch.utils.device import resolve_device


def kaiming_uniform(shape, a: float, generator: torch.Generator) -> torch.Tensor:
    """torch.nn.init.kaiming_uniform_(w, a) for a weight (out, in), drawn
    from `generator`: bound = sqrt(2 / (1 + a^2)) * sqrt(3 / fan_in)."""
    gain = math.sqrt(2.0 / (1.0 + a * a))
    bound = gain * math.sqrt(3.0 / shape[-1])
    return (torch.rand(shape, generator=generator) * 2.0 - 1.0) * bound


class KANLinear(nn.Module):
    """out = SiLU(x) @ base_weight.T
           + flatten(B_splines(x)) @ flatten(spline_weight * spline_scaler).T
    """

    def __init__(self, in_features: int, out_features: int,
                 grid_size: int = 5, spline_order: int = 3,
                 fused: bool = False,
                 compute_dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        dev = resolve_device(device)
        gen = generator if generator is not None else torch.Generator().manual_seed(0)
        self.in_features, self.out_features = in_features, out_features
        self.grid_size, self.spline_order = grid_size, spline_order
        self.fused, self.compute_dtype = fused, compute_dtype

        # the JAX layer's defaults: grid range (-1, 1), noise scale 0.1,
        # base and spline scales 1, a standalone spline scaler. Parameters
        # are drawn on the CPU from the generator (the spline init is a
        # small least-squares fit), then moved to the device.
        grid = bspline.make_grid(in_features, grid_size, spline_order)
        self.register_buffer("grid", grid)
        self.base_weight = nn.Parameter(kaiming_uniform(
            (out_features, in_features), math.sqrt(5), gen))
        noise = ((torch.rand((grid_size + 1, in_features, out_features),
                             generator=gen) - 0.5) * 0.1 / grid_size)
        pts = grid.T[spline_order:-spline_order]
        self.spline_weight = nn.Parameter(
            bspline.curve2coeff(pts, noise, grid, spline_order))
        self.spline_scaler = nn.Parameter(kaiming_uniform(
            (out_features, in_features), math.sqrt(5), gen))
        self.to(dev)

    @property
    def scaled_spline_weight(self) -> torch.Tensor:
        return self.spline_weight * self.spline_scaler[..., None]

    def forward(self, x: torch.Tensor, gin_graph=None) -> torch.Tensor:
        """With `gin_graph=(g, eps)` the layer computes
        KANLinear((1+eps)·x_i + Σ_j x_j) over the GraphBatch, the GIN conv
        fusion point (kernels/gin_fused.py runs it in one launch)."""
        orig_shape = x.shape
        x = x.reshape(-1, self.in_features)
        grid, wb, ws = self.grid, self.base_weight, self.scaled_spline_weight
        cd = self.compute_dtype
        if cd is not None:
            x, grid, wb, ws = x.to(cd), grid.to(cd), wb.to(cd), ws.to(cd)
        if gin_graph is not None:
            g, eps = gin_graph
            if self.fused and x.dtype in (torch.float32, torch.bfloat16):
                out = gin_kan_fused(x, g, eps, grid, wb, ws, self.spline_order)
                return out.reshape(*orig_shape[:-1], self.out_features)
            agg = segment.neighbor_sum(x, g, edge_weight=g.edge_mask.to(x.dtype))
            x = (1.0 + eps) * x + agg

        if self.fused:
            out = kan_linear_fused(x, grid, wb, ws, self.spline_order)
        else:
            base = F.silu(x) @ wb.T
            bases = bspline.b_splines(x, grid, self.spline_order)
            out = base + bases.reshape(x.shape[0], -1) @ ws.reshape(
                self.out_features, -1).T
        return out.reshape(*orig_shape[:-1], self.out_features)

    def regularization_loss(self, regularize_activation: float = 1.0,
                            regularize_entropy: float = 1.0) -> torch.Tensor:
        """Fake-L1 + entropy regularizer (reference ekan.py:213-233)."""
        l1_fake = self.spline_weight.abs().mean(-1)
        reg_act = l1_fake.sum()
        p = l1_fake / reg_act
        reg_ent = -torch.sum(p * torch.log(p))
        return regularize_activation * reg_act + regularize_entropy * reg_ent


class KAN(nn.Module):
    """Stack of KANLinear layers (reference ekan.py:236-281)."""

    def __init__(self, layers_hidden: Sequence[int], grid_size: int = 5,
                 spline_order: int = 3, fused: bool = False,
                 compute_dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.layers = nn.ModuleList(
            KANLinear(fin, fout, grid_size=grid_size,
                      spline_order=spline_order, fused=fused,
                      compute_dtype=compute_dtype, generator=generator,
                      device=device)
            for fin, fout in zip(layers_hidden[:-1], layers_hidden[1:]))

    def forward(self, x: torch.Tensor, mask=None, train: bool = False,
                gin_graph=None) -> torch.Tensor:
        # mask/train are accepted for the update-net calling convention;
        # gin_graph fuses the GIN aggregation into the FIRST layer
        del mask, train
        for i, layer in enumerate(self.layers):
            x = layer(x, gin_graph=gin_graph if i == 0 else None)
        return x
