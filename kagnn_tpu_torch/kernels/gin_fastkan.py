"""Fused GIN aggregate + FastKANLayer: the port of
`kagnn_tpu/pallas/gin_fastkan.py::_kernel` (forward) and `_gf_bwd`.

    z   = (1 + eps) * x_i + sum_{j in N(i)} x_j
    out = FastKANLayer(z)

which also emits z (in x's dtype) for the backward. As in the JAX kernel the
layer runs on the unrounded f32 z, the backward rebuilds it from the stored
z, and padded edges are not masked: they point at the masked last row, whose
output every consumer masks.

The backward (`_gf_bwd`) is the FastKANLayer backward kernel on z
(kernels/fastkan_layer.py), then the segment-sum kernel over the sender CSR
with the gather index `receivers_by_sender` (kernels/spmm.py), then
dx = (1 + eps) * dz + A^T dz. When x needs no gradient (the node features of
the first conv) the dz and A^T dz work is skipped.

The halo entry (`gin_fastkan_fused_halo`, the port of `_gin_fastkan_ext` /
`_gfe_bwd`) is kernels/gin_fused.py's halo entry with the FastKAN layer:
the aggregate over the extended table [x; halo] with the row pointers
ending at the valid edges (the edge mask), the FastKANLayer backward
kernel for dz and the layer's weight gradients (the shard's partials),
dext from the segment-sum kernel over the extended space's sender CSR,
dx = (1 + eps) * dz.

CUDA kernels: `csrc/gin_fastkan.cu` (see its header for the bound on the
H100 and the design), gin_fused's two passes: the aggregate as spmm's split
row sum (a receiver row of more than PIECE = 64 edges summed in pieces,
added in chunk order) writing z and, under bf16, the f32 z to scratch; then
the FastKANLayer on the f32 z, on the tensor cores under bf16 (the layer
forward's body), on the CUDA cores in f32. On a CPU tensor the wrapper runs
the plain version below; on a CUDA tensor it launches the kernels or
raises.
"""
from __future__ import annotations

import functools

import torch

from kagnn_tpu_torch.kernels import _build
from kagnn_tpu_torch.kernels._common import (aligned, check_cuda, dtype_code,
                                             segment_ids, stream_of)
from kagnn_tpu_torch.kernels.fastkan_layer import (c_centers, check_layer,
                                                   fastkan_forward_f32,
                                                   fastkan_layer_bwd, inv_h,
                                                   weight_layouts)
from kagnn_tpu_torch.kernels.spmm import sorted_segment_sum, split_scratch


def gin_fastkan_fwd_plain(x, senders, recv_row_ptr, lng, lnb, w, wb, bb,
                          eps, grid_min, grid_max, ext=None):
    """The plain version: gather (from ext, else x) + index_add_ into f32
    over the row pointer's edges, then the plain FastKANLayer on the f32
    aggregate. Returns (out, z)."""
    rows = segment_ids(recv_row_ptr)
    tab = x if ext is None else ext
    agg = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    agg.index_add_(0, rows,
                   tab.index_select(0, senders[:rows.numel()].long()).float())
    z32 = agg + (1.0 + eps) * x.float()
    out = fastkan_forward_f32(z32, lng, lnb, w, wb, bb, grid_min, grid_max,
                              x.dtype)
    return out, z32.to(x.dtype)


@functools.cache
def _fn(G: int):
    P, I, F = _build.P, _build.I, _build.F
    return _build.bind("gin_fastkan", "gin_fastkan_fwd",
                       [P, P, P, P, P, P, P, P, P, P, P, P, P, P, I, I, I, F,
                        I, I, P, F, I, P], (G,))


def gin_fastkan_fwd(x, senders, recv_row_ptr, lng, lnb, w, wb, bb,
                    eps: float, grid_min: float, grid_max: float, ext=None):
    """x (N, D), senders (E,) int32 in receiver-sorted order, recv_row_ptr
    (N+1,) int32, lng/lnb (D,), w (G*D, O), wb (D, O), bb (O,) ->
    (out (N, O), z (N, D)). With `ext` (M, D), the halo entry's extended
    table, the aggregate gathers from ext and only the edges up to
    recv_row_ptr[N] are summed."""
    if x.device.type == "cpu":
        return gin_fastkan_fwd_plain(x, senders, recv_row_ptr, lng, lnb, w,
                                     wb, bb, eps, grid_min, grid_max, ext=ext)
    code = dtype_code(x)
    n, D, O, G = check_layer(x, lng, lnb, w, wb, bb)
    check_cuda("recv_row_ptr", recv_row_ptr, torch.int32, (n + 1,))
    check_cuda("senders", senders, torch.int32, (None,))
    if ext is not None:
        check_cuda("ext", ext, x.dtype, (None, D))
    w, wb = aligned(w), aligned(wb)  # staged with cp.async under bf16
    out = torch.empty((n, O), dtype=x.dtype, device=x.device)
    z = torch.empty_like(x)
    # under bf16 the unrounded f32 z that the layer reads; the heavy rows'
    # pieces (two slots of D a chunk) and each chunk's first row
    z32 = (None if x.dtype == torch.float32 else
           torch.empty((n, D), dtype=torch.float32, device=x.device))
    edges = senders.numel()
    partial, first_row = split_scratch(edges, D, x.device)
    err = _fn(G)(x.data_ptr(), None if ext is None else ext.data_ptr(),
                 senders.data_ptr(), recv_row_ptr.data_ptr(),
                 lng.data_ptr(), lnb.data_ptr(), w.data_ptr(), wb.data_ptr(),
                 bb.data_ptr(), out.data_ptr(), z.data_ptr(),
                 None if z32 is None else z32.data_ptr(), partial.data_ptr(),
                 first_row.data_ptr(), n, D, O, float(eps), edges, G,
                 c_centers(grid_min, grid_max, G),
                 inv_h(grid_min, grid_max, G), code, stream_of(x))
    _build.check(err, "gin_fastkan_fwd")
    gin_fastkan_fwd.launches += 1
    return out, z


gin_fastkan_fwd.launches = 0


class GinFastKan(torch.autograd.Function):
    """The JAX `_gin_fastkan` custom VJP: forward through the fused kernel,
    backward through the FastKANLayer backward kernel and the segment
    sum."""

    @staticmethod
    def forward(ctx, x, g, lng, lnb, w, wb, bb, eps, grid_min, grid_max):
        out, z = gin_fastkan_fwd(x, g.senders, g.recv_row_ptr, lng, lnb, w,
                                 wb, bb, eps, grid_min, grid_max)
        ctx.save_for_backward(z, lng, lnb, w, wb)
        ctx.g, ctx.eps, ctx.grid = g, eps, (grid_min, grid_max)
        return out

    @staticmethod
    def backward(ctx, dout):
        z, lng, lnb, w, wb = ctx.saved_tensors
        need_x = ctx.needs_input_grad[0]
        dz, *dparams = fastkan_layer_bwd(z, lng, lnb, w, wb,
                                         dout.contiguous(), *ctx.grid,
                                         need_dx=need_x)
        dx = None
        if need_x:
            g = ctx.g
            dx_a = sorted_segment_sum(dz, g.send_row_ptr, g.receivers_by_sender)
            dx = (1.0 + ctx.eps) * dz + dx_a
        return (dx, None, *dparams, None, None, None)


class GinFastKanHalo(torch.autograd.Function):
    """The JAX `_gin_fastkan_ext` custom VJP (`_gfe_fwd`, `_gfe_bwd`): the
    fused kernel over the extended table; dz and the weight gradients from
    the FastKANLayer backward kernel, dext from the segment-sum kernel over
    the extended space's sender CSR, dx = (1 + eps) * dz."""

    @staticmethod
    def forward(ctx, x, ext, g, lng, lnb, w, wb, bb, eps, grid_min, grid_max):
        out, z = gin_fastkan_fwd(x, g.senders, g.recv_row_ptr, lng, lnb, w,
                                 wb, bb, eps, grid_min, grid_max, ext=ext)
        ctx.save_for_backward(z, lng, lnb, w, wb)
        ctx.g, ctx.eps, ctx.grid = g, eps, (grid_min, grid_max)
        return out

    @staticmethod
    def backward(ctx, dout):
        z, lng, lnb, w, wb = ctx.saved_tensors
        need = ctx.needs_input_grad[0] or ctx.needs_input_grad[1]
        dz, *dparams = fastkan_layer_bwd(z, lng, lnb, w, wb,
                                         dout.contiguous(), *ctx.grid,
                                         need_dx=need)
        dx = dext = None
        if need:
            g = ctx.g
            dext = sorted_segment_sum(dz, g.send_row_ptr, g.receivers_by_sender)
            dx = (1.0 + ctx.eps) * dz
        return (dx, dext, None, *dparams, None, None, None)


def gin_fastkan_fused_halo(x: torch.Tensor, g, eps: float, ln_scale, ln_bias,
                           spline_weight, base_weight, base_bias,
                           grid_min: float, grid_max: float,
                           num_grids: int) -> torch.Tensor:
    """The node-sharded fused GIN aggregate + FastKANLayer (JAX
    `gin_fastkan_fused_halo`) inside `ops.segment.halo_mode`: one
    differentiable halo exchange, then `GinFastKanHalo` on the shard.
    Layouts as `gin_fastkan_fused`."""
    from kagnn_tpu_torch.ops import segment

    x = x.contiguous()
    ext = segment.halo_extend(x)
    lng, lnb, w, wb, bb = weight_layouts(ln_scale, ln_bias, spline_weight,
                                         base_weight, base_bias, num_grids)
    return GinFastKanHalo.apply(x, ext, g, lng, lnb, w, wb, bb, float(eps),
                                float(grid_min), float(grid_max))


def gin_fastkan_fused(x: torch.Tensor, g, eps: float, ln_scale, ln_bias,
                      spline_weight, base_weight, base_bias, grid_min: float,
                      grid_max: float, num_grids: int) -> torch.Tensor:
    """Fused GINConv aggregate + FastKANLayer over a GraphBatch, from the
    module's layouts: spline_weight (O, D*G), base_weight (O, D),
    base_bias (O,), ln_scale/ln_bias (D,)."""
    lng, lnb, w, wb, bb = weight_layouts(ln_scale, ln_bias, spline_weight,
                                         base_weight, base_bias, num_grids)
    return GinFastKan.apply(x.contiguous(), g, lng, lnb, w, wb, bb,
                            float(eps), float(grid_min), float(grid_max))
