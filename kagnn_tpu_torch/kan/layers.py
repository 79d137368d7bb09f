"""Kolmogorov–Arnold layers, the counterparts of `kagnn_tpu/kan/layers.py`:
the B-spline `KANLinear` and `KAN` (efficient-kan semantics) and the RBF
`FastKANLayer` and `FastKAN` (fastkan semantics).

Parameters keep the reference torch names and layouts: `base_weight`
(out, in), `spline_weight` (out, in, grid+order), `spline_scaler`
(out, in) and the knot buffer `grid` (in, grid + 2*order + 1) for
KANLinear; `spline_linear.weight` (out, in*num_grids, column d*G + g),
`layernorm.{weight,bias}` (in,) and `base_linear.{weight,bias}` for
FastKANLayer.

Under a compute dtype the input and the weights are cast to it where the
JAX layers cast them (`layers.py:121-123`, `:276-301`, `:319-323`); the
parameters stay f32 master weights.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from kagnn_tpu_torch.kan import bspline, rbf
from kagnn_tpu_torch.kernels.bspline_fused import kan_linear_fused
from kagnn_tpu_torch.kernels.fastkan_layer import fastkan_layer_fused
from kagnn_tpu_torch.kernels.gin_fastkan import (gin_fastkan_fused,
                                                 gin_fastkan_fused_halo)
from kagnn_tpu_torch.kernels.gin_fused import gin_kan_fused, gin_kan_fused_halo
from kagnn_tpu_torch.kernels.rbf_fused import fastkan_fused
from kagnn_tpu_torch.ops import segment
from kagnn_tpu_torch.utils.device import resolve_device

# the RBF centers' range of every FastKANLayer (the JAX layer's default)
GRID_MIN, GRID_MAX = -2.0, 2.0

def _fused_gin_entry(single, halo):
    """The fused GIN entry for the current distribution mode (JAX
    `kan/layers.py:125-142, :291-303`): the halo entry under
    `segment.halo_mode`, the single-card entry otherwise. Under
    `segment.edge_axis` a fused GIN aggregate would be the shard's partial
    sum, taken before a nonlinear layer; the JAX edge-partitioned step
    refuses it (its custom VJP's weight gradients vary over the edge axis),
    and so does the port."""
    if segment.halo_state() is not None:
        return halo
    if segment.current_edge_axis() is not None:
        raise ValueError("a fused GIN aggregate cannot run under the edge "
                         "partition (its sum over the shard's edges feeds a "
                         "nonlinear layer before any all-reduce): build the "
                         "model with fused=False for make_edge_partitioned_"
                         "node_step, as the JAX package requires")
    return single


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

    def kan_input(self, x: torch.Tensor, gin_graph=None) -> torch.Tensor:
        """The transform's input as the unfused forward computes it, the
        tensor the JAX layer sows as "kan_in" for grid adaptation: x as
        (rows, in) in the compute dtype and, with `gin_graph=(g, eps)`,
        (1+eps)·x_i + Σ_j x_j summed by `segment.neighbor_sum`."""
        x = x.reshape(-1, self.in_features)
        if self.compute_dtype is not None:
            x = x.to(self.compute_dtype)
        if gin_graph is not None:
            g, eps = gin_graph
            agg = segment.neighbor_sum(x, g, edge_weight=g.edge_mask.to(x.dtype))
            x = (1.0 + eps) * x + agg
        return x

    def forward(self, x: torch.Tensor, gin_graph=None) -> torch.Tensor:
        """With `gin_graph=(g, eps)` the layer computes
        KANLinear((1+eps)·x_i + Σ_j x_j) over the GraphBatch, the GIN conv
        fusion point (kernels/gin_fused.py runs it in one launch; under
        `segment.halo_mode` its halo entry over the extended table)."""
        orig_shape = x.shape
        grid, wb, ws = self.grid, self.base_weight, self.scaled_spline_weight
        cd = self.compute_dtype
        if cd is not None:
            grid, wb, ws = grid.to(cd), wb.to(cd), ws.to(cd)
        if gin_graph is not None and self.fused:
            g, eps = gin_graph
            x = x.reshape(-1, self.in_features)
            x = x if cd is None else x.to(cd)
            fn = _fused_gin_entry(gin_kan_fused, gin_kan_fused_halo)
            out = fn(x, g, eps, grid, wb, ws, self.spline_order)
            return out.reshape(*orig_shape[:-1], self.out_features)
        x = self.kan_input(x, gin_graph)

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


class FastKANLayer(nn.Module):
    """RBF KAN layer (reference fastkan.py:49-85):
        spline_linear(rbf(layernorm(x))) + base_linear(silu(x))
    with centers linspace(-2, 2, num_grids) and width 4 / (num_grids - 1).
    The layernorm and the base update are optional, as in the JAX layer; a
    flag that is off creates no submodule, so the state_dict has the
    reference's keys. The grid range, SiLU and the spline weight's init
    scale 0.1 are the JAX layer's defaults and all that its models use."""

    def __init__(self, input_dim: int, output_dim: int, num_grids: int = 8,
                 use_base_update: bool = True, use_layernorm: bool = True,
                 fused: bool = False,
                 compute_dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        dev = resolve_device(device)
        gen = generator if generator is not None else torch.Generator().manual_seed(0)
        if use_layernorm and input_dim <= 1:
            raise ValueError("Do not use layernorms on 1D inputs. Set "
                             "use_layernorm=False.")
        self.input_dim, self.output_dim = input_dim, output_dim
        self.num_grids = num_grids
        self.use_base_update, self.use_layernorm = use_base_update, use_layernorm
        self.fused, self.compute_dtype = fused, compute_dtype
        self.denominator = (GRID_MAX - GRID_MIN) / (num_grids - 1)
        if use_layernorm:
            self.layernorm = nn.LayerNorm(input_dim, eps=1e-5)
        # the holders are made uninitialised and filled from `gen` (on the
        # CPU), as the JAX layer draws them: a truncated normal on [-2, 2]
        # times 0.1 for the spline weight, U(-1/sqrt(in), 1/sqrt(in)) for the
        # base weight and bias (torch nn.Linear's)
        self.spline_linear = nn.utils.skip_init(
            nn.Linear, input_dim * num_grids, output_dim, bias=False)
        if use_base_update:
            self.base_linear = nn.utils.skip_init(nn.Linear, input_dim, output_dim)
        with torch.no_grad():
            nn.init.trunc_normal_(self.spline_linear.weight, 0.0, 1.0, -2.0,
                                  2.0, generator=gen)
            self.spline_linear.weight.mul_(0.1)
            if use_base_update:
                bound = 1.0 / math.sqrt(input_dim)
                for p in (self.base_linear.weight, self.base_linear.bias):
                    p.copy_((torch.rand(p.shape, generator=gen) * 2.0 - 1.0) * bound)
        self.to(dev)

    def _cast(self, *ts):
        cd = self.compute_dtype
        return ts if cd is None else tuple(t.to(cd) for t in ts)

    def forward(self, x: torch.Tensor, use_layernorm: bool = True,
                gin_graph=None) -> torch.Tensor:
        """Routes as the JAX layer (`layers.py:282-345`): with `fused` and
        the base update and both layernorm flags on, the whole layer is one
        kernel (kernels/fastkan_layer.py; with `gin_graph=(g, eps)` the GIN
        fusion point, kernels/gin_fastkan.py, FastKAN((1+eps)·x_i + Σ_j
        x_j)); otherwise the layernorm if both flags are on, the basis
        product (kernels/rbf_fused.py when `fused`) and the base update if
        it is on."""
        orig_shape = x.shape
        x = x.reshape(-1, self.input_dim)
        x, sw = self._cast(x, self.spline_linear.weight)
        grid = (GRID_MIN, GRID_MAX, self.num_grids)
        ln = self.use_layernorm and use_layernorm
        whole = self.fused and self.use_base_update and ln
        if whole:
            lng, lnb, wb, bb = self._cast(
                self.layernorm.weight, self.layernorm.bias,
                self.base_linear.weight, self.base_linear.bias)
        if gin_graph is not None:
            g, eps = gin_graph
            if whole:
                fn = _fused_gin_entry(gin_fastkan_fused, gin_fastkan_fused_halo)
                out = fn(x, g, eps, lng, lnb, sw, wb, bb, *grid)
                return out.reshape(*orig_shape[:-1], self.output_dim)
            agg = segment.neighbor_sum(x, g, edge_weight=g.edge_mask.to(x.dtype))
            x = (1.0 + eps) * x + agg
        if whole:
            out = fastkan_layer_fused(x, lng, lnb, sw, wb, bb, *grid)
            return out.reshape(*orig_shape[:-1], self.output_dim)
        # the JAX LayerNorm computes in f32 and returns f32 (its f32 scale
        # promotes a bf16 input), and the basis meets the cast spline weight
        # in f32; without it the basis stays in x's dtype
        xs = (F.layer_norm(x.float(), (self.input_dim,), self.layernorm.weight,
                           self.layernorm.bias, 1e-5) if ln else x)
        if self.fused:
            ret = fastkan_fused(xs, sw, *grid)
        else:
            centers = rbf.make_rbf_grid(*grid, device=x.device).to(xs.dtype)
            basis = rbf.rbf_basis(xs, centers, self.denominator)
            ret = basis.reshape(x.shape[0], -1) @ sw.to(basis.dtype).T
        if self.use_base_update:
            wb, bb = self._cast(self.base_linear.weight, self.base_linear.bias)
            ret = ret + F.silu(x) @ wb.T + bb
        return ret.reshape(*orig_shape[:-1], self.output_dim)


class FastKAN(nn.Module):
    """Stack of FastKANLayer (reference fastkan.py:118-145); its layers keep
    the layernorm on."""

    def __init__(self, layers_hidden: Sequence[int], num_grids: int = 8,
                 use_base_update: bool = True, fused: bool = False,
                 compute_dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.layers = nn.ModuleList(
            FastKANLayer(fin, fout, num_grids=num_grids,
                         use_base_update=use_base_update, fused=fused,
                         compute_dtype=compute_dtype, generator=generator,
                         device=device)
            for fin, fout in zip(layers_hidden[:-1], layers_hidden[1:]))

    def forward(self, x: torch.Tensor, mask=None, train: bool = False,
                gin_graph=None) -> torch.Tensor:
        # the update-net calling convention of KAN; gin_graph fuses the GIN
        # aggregation into the FIRST layer
        del mask, train
        for i, layer in enumerate(self.layers):
            x = layer(x, gin_graph=gin_graph if i == 0 else None)
        return x
