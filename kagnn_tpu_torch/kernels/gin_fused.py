"""Fused GIN aggregate + B-spline KANLinear: the port of
`kagnn_tpu/pallas/gin_fused.py::_kernel` (forward) and `_gk_bwd`.

    z   = (1 + eps) * x_i + sum_{j in N(i)} x_j
    out = KANLinear(z)

in one launch, which also emits z (in x's dtype) for the backward. As in the
JAX kernel the ladder runs on the unrounded f32 z, the backward rebuilds it
from the stored z, and padded edges are not masked: they point at the masked
last row, whose output every consumer masks.

The backward (`_gk_bwd`) is the KANLinear backward kernel on z
(kernels/bspline_fused.py), then the segment-sum kernel over the sender CSR
with the gather index `receivers_by_sender` (kernels/spmm.py), then
dx = (1 + eps) * dz + A^T dz. When x needs no gradient (the node features of
the first conv) the dz and A^T dz work is skipped.

The halo entry (`gin_kan_fused_halo`, the port of `_gin_kan_ext` /
`_gke_bwd` and `gin_kan_fused_halo`) runs on one rank's node shard under
the halo partition (ops/segment.py `halo_mode`): the aggregate gathers
from the extended table ext = [x; halo] of B + D*H rows, the self term
reads x. It keeps the edge mask: the plan's padded edges are the tail
[n_edge, E) and point at local row B-1, a valid node on interior shards,
so the shard's row pointers end at n_edge (dist/halo.py) and neither
kernel walks them, in place of the JAX entry's multiply. Its backward is
the KANLinear backward kernel on z for dz, then dext, the sender segment
sum of dz over the extended space's CSR (the same segment-sum kernel), and
dx = (1 + eps) * dz with no A^T dz term; the exchange's backward carries
dext's halo rows to their owners. The weight gradients stay the shard's
partials, which the step averages over the ranks.

CUDA kernels: `csrc/gin_fused.cu` (see its header for the bound on the H100
and the design): the aggregate as spmm's split row sum (a receiver row of
more than PIECE = 64 edges summed in pieces, added in chunk order) writing
z and, under bf16, the f32 z to scratch; then the KANLinear on the f32 z,
on the tensor cores under bf16 (the B-spline forward's tile), on the CUDA
cores in f32. On a CPU tensor the wrapper runs the plain version below; on
a CUDA tensor it launches the kernels or raises.
"""
from __future__ import annotations

import functools

import torch

from kagnn_tpu_torch.kernels import _build
from kagnn_tpu_torch.kernels._common import (aligned, check_cuda,
                                             dtype_code, segment_ids,
                                             stream_of)
from kagnn_tpu_torch.kernels.bspline_fused import (_check_layer,
                                                   kan_forward_f32,
                                                   kan_linear_bwd,
                                                   weight_layouts)
from kagnn_tpu_torch.kernels.spmm import sorted_segment_sum, split_scratch


def gin_kan_fwd_plain(x, senders, recv_row_ptr, knots, wb, ws, k, eps,
                      ext=None):
    """The plain version: gather (from ext, else x) + index_add_ into f32
    over the row pointer's edges, then the plain KANLinear on the f32
    aggregate. Returns (out, z)."""
    rows = segment_ids(recv_row_ptr)
    tab = x if ext is None else ext
    agg = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    agg.index_add_(0, rows,
                   tab.index_select(0, senders[:rows.numel()].long()).float())
    z32 = agg + (1.0 + eps) * x.float()
    return kan_forward_f32(z32, knots, wb, ws, k, x.dtype), z32.to(x.dtype)


@functools.cache
def _fn(k: int, grid: int):
    P, I, F = _build.P, _build.I, _build.F
    return _build.bind("gin_fused", "gin_fwd",
                       [P, P, P, P, P, P, P, P, P, P, P, P, I, I, I, F, I, I,
                        I, I, P], (k, grid))


def gin_kan_fwd(x, senders, recv_row_ptr, knots, wb, ws, k: int, eps: float,
                ext=None):
    """x (N, D), senders (E,) int32 in receiver-sorted order, recv_row_ptr
    (N+1,) int32, knots (K, D), wb (D, O), ws (n_basis*D, O) -> (out (N, O),
    z (N, D)). With `ext` (M, D), the halo entry's extended table, the
    aggregate gathers from ext (senders index it) and only the edges up to
    recv_row_ptr[N] are summed."""
    if x.device.type == "cpu":
        return gin_kan_fwd_plain(x, senders, recv_row_ptr, knots, wb, ws, k,
                                 eps, ext=ext)
    code = dtype_code(x)
    n, D, O, grid = _check_layer(x, knots, wb, ws, k)
    check_cuda("recv_row_ptr", recv_row_ptr, torch.int32, (n + 1,))
    check_cuda("senders", senders, torch.int32, (None,))
    if ext is not None:
        check_cuda("ext", ext, x.dtype, (None, D))
    wb, ws = aligned(wb), aligned(ws)  # staged with cp.async under bf16
    out = torch.empty((n, O), dtype=x.dtype, device=x.device)
    z = torch.empty_like(x)
    # under bf16 the unrounded f32 z that the forward reads; the heavy rows'
    # pieces (two slots of D a chunk) and each chunk's first row
    z32 = (None if x.dtype == torch.float32 else
           torch.empty((n, D), dtype=torch.float32, device=x.device))
    edges = senders.numel()
    partial, first_row = split_scratch(edges, D, x.device)
    err = _fn(k, grid)(x.data_ptr(), None if ext is None else ext.data_ptr(),
                       senders.data_ptr(),
                       recv_row_ptr.data_ptr(), knots.data_ptr(),
                       wb.data_ptr(), ws.data_ptr(), out.data_ptr(),
                       z.data_ptr(), None if z32 is None else z32.data_ptr(),
                       partial.data_ptr(), first_row.data_ptr(), n, D, O,
                       float(eps), edges, grid, k, code, stream_of(x))
    _build.check(err, "gin_fwd")
    gin_kan_fwd.launches += 1
    return out, z


gin_kan_fwd.launches = 0


class GinKan(torch.autograd.Function):
    """The JAX `_gin_kan` custom VJP: forward through the fused GIN kernel,
    backward through the KANLinear backward kernel and the segment sum."""

    @staticmethod
    def forward(ctx, x, g, knots, wb, ws, eps, k):
        out, z = gin_kan_fwd(x, g.senders, g.recv_row_ptr, knots, wb, ws, k,
                             eps)
        ctx.save_for_backward(z, knots, wb, ws)
        ctx.g, ctx.eps, ctx.k = g, eps, k
        return out

    @staticmethod
    def backward(ctx, dout):
        z, knots, wb, ws = ctx.saved_tensors
        need_x = ctx.needs_input_grad[0]
        dz, dwb, dws = kan_linear_bwd(z, knots, wb, ws, dout.contiguous(),
                                      ctx.k, need_dx=need_x)
        dx = None
        if need_x:
            g = ctx.g
            dx_a = sorted_segment_sum(dz, g.send_row_ptr, g.receivers_by_sender)
            dx = (1.0 + ctx.eps) * dz + dx_a
        return dx, None, None, dwb, dws, None, None


class GinKanHalo(torch.autograd.Function):
    """The JAX `_gin_kan_ext` custom VJP (`_gke_fwd`, `_gke_bwd`): the
    forward through the fused GIN kernel over the extended table; the
    backward gives dz from the KANLinear backward kernel, dext as the
    segment-sum kernel over the sender CSR of the extended space
    (send_row_ptr, gather index receivers_by_sender, both ending at the
    valid edges), and dx = (1 + eps) * dz."""

    @staticmethod
    def forward(ctx, x, ext, g, knots, wb, ws, eps, k):
        out, z = gin_kan_fwd(x, g.senders, g.recv_row_ptr, knots, wb, ws, k,
                             eps, ext=ext)
        ctx.save_for_backward(z, knots, wb, ws)
        ctx.g, ctx.eps, ctx.k = g, eps, k
        return out

    @staticmethod
    def backward(ctx, dout):
        z, knots, wb, ws = ctx.saved_tensors
        need = ctx.needs_input_grad[0] or ctx.needs_input_grad[1]
        dz, dwb, dws = kan_linear_bwd(z, knots, wb, ws, dout.contiguous(),
                                      ctx.k, need_dx=need)
        dx = dext = None
        if need:
            g = ctx.g
            dext = sorted_segment_sum(dz, g.send_row_ptr, g.receivers_by_sender)
            dx = (1.0 + ctx.eps) * dz
        return dx, dext, None, None, dwb, dws, None, None


def gin_kan_fused_halo(x: torch.Tensor, g, eps: float, grid: torch.Tensor,
                       base_weight: torch.Tensor,
                       scaled_spline_weight: torch.Tensor,
                       spline_order: int) -> torch.Tensor:
    """The node-sharded fused GIN aggregate + KANLinear (JAX
    `gin_kan_fused_halo`), inside `ops.segment.halo_mode`: one
    differentiable halo exchange builds the extended sender table, then
    `GinKanHalo` runs on the shard. Layouts as `gin_kan_fused`."""
    from kagnn_tpu_torch.ops import segment

    x = x.contiguous()
    ext = segment.halo_extend(x)
    knots, wb, ws = weight_layouts(grid, base_weight, scaled_spline_weight)
    return GinKanHalo.apply(x, ext, g, knots, wb, ws, float(eps),
                            int(spline_order))


def gin_kan_fused(x: torch.Tensor, g, eps: float, grid: torch.Tensor,
                  base_weight: torch.Tensor,
                  scaled_spline_weight: torch.Tensor,
                  spline_order: int) -> torch.Tensor:
    """Fused GINConv aggregate + KANLinear over a GraphBatch, from the
    module's layouts: base_weight (O, D), scaled_spline_weight
    (O, D, n_basis), grid (D, K)."""
    knots, wb, ws = weight_layouts(grid, base_weight, scaled_spline_weight)
    return GinKan.apply(x.contiguous(), g, knots, wb, ws, float(eps),
                        int(spline_order))
