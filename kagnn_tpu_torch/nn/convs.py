"""Graph convolutions over a padded `GraphBatch`, the counterparts of
`kagnn_tpu/nn/convs.py`:

  * `GINConv` — update((1+eps)·x_i + Σ_j x_j) with a KAN, FastKAN or MLP
    update net (the aggregation fuses into a KAN net's first layer);
  * `GCNConv` — D^-1/2 (A+I) D^-1/2 · t(x) + b with the self-loops in closed
    form, the transform t from a factory (fin, fout) -> KANLinear,
    FastKANLayer or the bias-free Glorot linear of `dense_transform`;
  * `GATConv` — multi-head attention with LeakyReLU(0.2) logits, a
    per-destination softmax over the edges and the implicit self-loop,
    concatenated heads and a bias, the transform from the same factories;
  * `GINEConv` — update((1+eps)·x_i + Σ_j ReLU(x_j + e_ij)), GIN with edge
    features (PyG GINEConv);
  * `global_add_pool`, `global_mean_pool` — node rows summed or averaged
    per graph over `node_graph`."""
from __future__ import annotations

import math
from typing import Callable, Optional

import torch
from torch import nn

from kagnn_tpu_torch.kan.layers import KAN, FastKANLayer, KANLinear
from kagnn_tpu_torch.kernels._common import leaky
from kagnn_tpu_torch.nn.mlp import TorchLinear
from kagnn_tpu_torch.ops import segment
from kagnn_tpu_torch.utils.device import resolve_device

TransformFactory = Callable[[int, int], nn.Module]


def dense_transform(**kw) -> TransformFactory:
    """PyG's internal conv `Linear` (the JAX `dense_transform`, a bias-free
    flax Dense with Glorot-uniform init): a bias-free `TorchLinear` with
    the bound sqrt(6 / (fin + fout)); `kw` goes to it (generator, device).
    Like the JAX Dense it promotes a bf16 input to the f32 weight's
    dtype."""
    def make(fin: int, fout: int) -> nn.Module:
        return TorchLinear(fin, fout, use_bias=False,
                           bound=math.sqrt(6.0 / (fin + fout)), **kw)
    return make


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
    train_eps=False). As in the JAX layer, the aggregation fuses into the
    update net's first layer only for a KAN net (kernels/gin_fused.py when
    the net is fused); any other net gets z summed in the compute dtype by
    `segment.neighbor_sum`, through the segment-sum kernel when `fused`."""

    def __init__(self, update: nn.Module, eps: float = 0.0,
                 fused: bool = False):
        super().__init__()
        self.update, self.eps, self.fused = update, eps, fused

    def forward(self, g, x: torch.Tensor) -> torch.Tensor:
        if isinstance(self.update, KAN):
            return self.update(x, mask=g.node_mask, train=self.training,
                               gin_graph=(g, self.eps))
        weight = None if self.fused else g.edge_mask.to(x.dtype)
        agg = segment.neighbor_sum(x, g, edge_weight=weight, fused=self.fused)
        return self.update((1.0 + self.eps) * x + agg, mask=g.node_mask,
                           train=self.training)


def _degree_with_self_loops(g, dtype: torch.dtype) -> torch.Tensor:
    """d_i = 1 + #incoming valid edges, in `dtype`. As in the JAX package
    the in-degree is cast BEFORE the +1 (and the rsqrt that follows), so
    under bf16 a degree above 256 rounds. `in_degrees` is a node leaf that
    the batcher counts over all valid edges, and the edge partition slices
    only the edge leaves (dist/mesh.py), so under `edge_axis` it is the
    global count already: the JAX package's branch for batches that ship
    in-degrees, which needs no all-reduce (its psum serves batches without
    them, which the port's batchers never make)."""
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
        hs = segment.halo_state()
        if hs is not None:
            # node-sharded (the JAX halo branch): the plan ships d^-1/2 in
            # the extended [local; halo] space, in f32, cast to h's dtype;
            # the halo neighbor sum takes the masked per-edge norm, and the
            # self-loop weighs d_i^-1
            dinv_ext = hs.dinv_ext.to(h.dtype)
            dinv = dinv_ext[:hs.n_local]
            norm = dinv_ext[g.senders.long()] * dinv[g.receivers.long()]
            norm = torch.where(g.edge_mask, norm,
                               torch.zeros((), dtype=h.dtype, device=h.device))
            out = segment.neighbor_sum(h, g, edge_weight=norm, fused=self.fused)
            out = out + h * (dinv * dinv)[:, None]
            return out + self.bias
        dinv = torch.rsqrt(_degree_with_self_loops(g, h.dtype))
        hs = h * dinv[:, None]
        out = segment.gcn_aggregate(hs, g, dinv, fused=self.fused)
        return out + self.bias


NEGATIVE_SLOPE = 0.2  # GAT's LeakyReLU slope (PyG's default, all the JAX models use)


class GATConv(nn.Module):
    """Multi-head graph attention (PyG GATConv defaults: LeakyReLU slope
    0.2, implicit self-loops, concatenated heads, a bias), the non-halo
    branch of the JAX layer: h = t(x) (N, H·C), per-head logits
    alpha_src = h @ amat and alpha_dst = h @ amat_dst with amat the
    block-diagonal (H·C, H) expansion of att_src (1, H, C), then
    `segment.gat_attention` (the GAT kernels when `fused`).

    Under a compute dtype the two expansions are rounded once to it and
    kept in f32, and the logits are products of the rounded h with f32
    sums, as the JAX layer's `dot_general(..., preferred_element_type=f32)`;
    the f32 bias promotes the conv's output to f32, as in GCN. att_src and
    att_dst are drawn from `generator` with flax's glorot bound for a
    (1, H, C) shape, sqrt(6 / (H + C))."""

    def __init__(self, in_features: int, out_features: int, heads: int,
                 transform: TransformFactory, fused: bool = False,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        dev = resolve_device(device)
        gen = generator if generator is not None else torch.Generator().manual_seed(0)
        self.heads, self.out_features = heads, out_features
        self.fused = fused
        self.transform = transform(in_features, heads * out_features)
        bound = math.sqrt(6.0 / (heads + out_features))
        for name in ("att_src", "att_dst"):
            w = (torch.rand((1, heads, out_features), generator=gen) * 2.0
                 - 1.0) * bound
            setattr(self, name, nn.Parameter(w.to(dev)))
        self.bias = nn.Parameter(torch.zeros(heads * out_features, device=dev))

    def _expand(self, att: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        """(1, H, C) -> the block-diagonal (H·C, H), rounded once to
        `dtype` when that is not f32."""
        H, C = self.heads, self.out_features
        eye = torch.eye(H, dtype=att.dtype, device=att.device)
        amat = (att[0][:, :, None] * eye[:, None, :]).reshape(H * C, H)
        return amat if dtype == torch.float32 else amat.to(dtype).float()

    def forward(self, g, x: torch.Tensor) -> torch.Tensor:
        h = self.transform(x)
        hs = segment.halo_state()
        if hs is not None:
            return self._halo_forward(g, h, hs) + self.bias
        amat = self._expand(self.att_src, h.dtype)
        hf = h.float()
        alpha_src = hf @ amat
        alpha_dst = hf @ self._expand(self.att_dst, h.dtype)
        out = segment.gat_attention(h, alpha_src, alpha_dst, g, NEGATIVE_SLOPE,
                                    att_src_matrix=amat, fused=self.fused)
        return out + self.bias

    def _halo_forward(self, g, h: torch.Tensor, hs) -> torch.Tensor:
        """The JAX halo branch: one exchange of h gives the extended table;
        alpha_src of the remote senders is re-derived from it (a function
        of h, so no second exchange), and since every edge of a receiver is
        local the softmax needs no collective. The logits are the products
        with the f32 att vectors summed over C, as the JAX branch computes
        them (not its non-halo dots)."""
        H, C, B = self.heads, self.out_features, hs.n_local
        h_ext = segment.halo_extend(h).reshape(-1, H, C)
        alpha_src_ext = (h_ext * self.att_src).sum(-1)
        alpha_src = alpha_src_ext[:B]
        h3 = h.reshape(-1, H, C)
        alpha_dst = (h3 * self.att_dst).sum(-1)
        logits = leaky(alpha_src_ext[g.senders.long()]
                       + alpha_dst[g.receivers.long()], NEGATIVE_SLOPE)
        self_logits = leaky(alpha_src + alpha_dst, NEGATIVE_SLOPE)
        w_edge, w_self = segment.segment_softmax(
            logits, g.receivers, B, mask=g.edge_mask, extra_logits=self_logits)
        out = segment.neighbor_sum_attn(h_ext.reshape(-1, H * C), g, w_edge)
        out = out.reshape(-1, H, C) + h3 * w_self[..., None]
        return out.reshape(-1, H * C)


class GINEConv(nn.Module):
    """GINE layer: messages ReLU(x_j + e_ij), zeroed at padded edges,
    summed per receiver, then update((1+eps)·x_i + agg) (PyG GINEConv, eps
    fixed). It never fuses with the update net: the JAX layer calls the net
    on the sum. With `fused` the receiver sum runs the segment-sum kernel
    over recv_row_ptr and the gradient to x the same kernel over the sender
    CSR (`segment.sender_gather`).

    An f32 e (the BondEncoder's output) promotes a bf16 x: the messages,
    their sum and z are f32, and a KAN net casts z back to its compute
    dtype, as in the JAX model."""

    def __init__(self, update: nn.Module, eps: float = 0.0,
                 fused: bool = False):
        super().__init__()
        self.update, self.eps, self.fused = update, eps, fused

    def forward(self, g, x: torch.Tensor, edge_attr: torch.Tensor) -> torch.Tensor:
        msgs = torch.relu(segment.sender_gather(x, g, fused=self.fused) + edge_attr)
        msgs = torch.where(g.edge_mask[:, None], msgs,
                           torch.zeros((), dtype=msgs.dtype, device=msgs.device))
        hs = segment.halo_state()
        agg = segment.segment_sum(msgs, g.receivers,
                                  g.n_node_pad if hs is None else hs.n_local,
                                  g.recv_row_ptr, fused=self.fused)
        return self.update((1.0 + self.eps) * x + agg, mask=g.node_mask,
                           train=self.training)


def global_add_pool(g, x: torch.Tensor, fused: bool = False) -> torch.Tensor:
    """Sum-pool node rows per graph, masked rows zeroed first: (G, F). With
    `fused` the sum runs the segment-sum kernel over graph_row_ptr."""
    x = torch.where(g.node_mask[:, None], x,
                    torch.zeros((), dtype=x.dtype, device=x.device))
    # a node->graph reduction: node rows are replicated under the edge
    # partition, so its all-reduce is suspended here
    with segment.edge_axis(None):
        return segment.segment_sum(x, g.node_graph, g.n_graph_pad,
                                   g.graph_row_ptr, fused=fused)


def global_mean_pool(g, x: torch.Tensor, fused: bool = False) -> torch.Tensor:
    """Mean-pool node rows per graph over the valid nodes: (G, F); an
    empty graph's row is 0. The edge partition's all-reduce is suspended,
    as in global_add_pool."""
    with segment.edge_axis(None):
        return segment.segment_mean(x, g.node_graph, g.n_graph_pad,
                                    mask=g.node_mask, row_ptr=g.graph_row_ptr,
                                    fused=fused)
