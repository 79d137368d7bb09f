"""Fused B-spline KANLinear forward and backward: the port of
`kagnn_tpu/pallas/bspline_fused.py::_fwd_kernel` and `::_bwd_kernel`.

    out = SiLU(x) @ Wb + sum_g B_g(x) @ Ws_g

with the Cox–de Boor ladder built in f32 on per-feature knots (K, D), SiLU(x)
and the bases cast to the compute dtype before the products, and f32 sums.
The backward rebuilds the ladder from x and uses the analytic derivative
    dB_g/dx = k * (B^{k-1}_g / (t_{g+k} - t_g) - B^{k-1}_{g+1} / (t_{g+k+1} - t_{g+1})).

Layouts are the JAX kernel's: x (N, D), knots (K, D), wb (D, O) and the
spline weight flattened to ws (n_basis*D, O) with row g*D + d.

The weight gradients are summed as the JAX backward sums them: one f32
partial per 128-row tile, added in tile order into a gradient held in the
weights' dtype (each partial and the running sum rounded after every tile;
`_common.tiled_gram`).

CUDA kernels: `csrc/bspline_fused.cu` (see its header for the bound on the
H100 and the design; under bf16 the forward's and the backward's products
run on the tensor cores, in f32 on the CUDA cores, and the backward's dx
kernel runs on a second stream beside its dW kernels), one library per
(spline order, grid size), built at its first use: any order 1-4 and grid
1-16 (`ORDERS`, `GRIDS`), the search spaces of the experiment scripts. On a CPU tensor the wrappers run the plain
versions below; on a CUDA tensor they launch the kernels or raise.
"""
from __future__ import annotations

import functools

import torch

from kagnn_tpu_torch.kernels import _build
from kagnn_tpu_torch.kernels._common import (SMEM_LIMIT, aligned,
                                             check_cuda, dtype_code,
                                             stream_of, tiled_gram,
                                             walk_window)

ORDERS, GRIDS = range(1, 5), range(1, 17)  # the shapes the kernels take
D_CHUNK, O_TILE = 32, 64  # csrc/kan_common.cuh kDC, kOT
MMA_ROWS, X_PITCH = 32, D_CHUNK + 8  # csrc/bspline_fused.cu kMmaRows, kXPitch
JAX_TILE = 128  # rows per tile of the JAX backward (DEFAULT_TILE_N)


def basis_ladder(x32: torch.Tensor, t32: torch.Tensor, k: int,
                 keep_penultimate: bool = False):
    """The shared Cox–de Boor recursion (JAX `_basis_ladder`) on (N, D)
    f32 tensors with knots t32 (K, D). Returns (bases, penultimate): lists
    of (N, D) tensors, the order-k bases and (if asked) the order-(k-1)."""
    n_knots = t32.shape[0]

    def t(j):
        return t32[j][None, :]

    xt = [x32 - t(j) for j in range(n_knots)]
    b = [((xt[j] >= 0) & (xt[j + 1] < 0)).to(x32.dtype)
         for j in range(n_knots - 1)]
    pen = None
    for kk in range(1, k + 1):
        if kk == k:
            pen = b
        b = [xt[j] * (1.0 / (t(j + kk) - t(j))) * b[j]
             - xt[j + kk + 1] * (1.0 / (t(j + kk + 1) - t(j + 1))) * b[j + 1]
             for j in range(len(b) - 1)]
    return b, (pen if keep_penultimate else None)


def kan_forward_f32(x32: torch.Tensor, knots: torch.Tensor, wb: torch.Tensor,
                    ws: torch.Tensor, k: int, dtype: torch.dtype) -> torch.Tensor:
    """Plain KANLinear forward of an f32 input whose operands round to
    `dtype` (shared with the GIN kernel's plain version, which feeds the
    unrounded f32 aggregate)."""
    sx = (x32 * torch.sigmoid(x32)).to(dtype)
    bases, _ = basis_ladder(x32, knots.float(), k)
    basis = torch.cat(bases, dim=1).to(dtype)
    acc = sx.float() @ wb.float() + basis.float() @ ws.float()
    return acc.to(dtype)


def kan_linear_fwd_plain(x, knots, wb, ws, k):
    return kan_forward_f32(x.float(), knots, wb, ws, k, x.dtype)


def dw_operand(x, knots, k):
    """[SiLU(x) | B_0(x) .. B_NB-1(x)] (N, (NB+1)*D), rounded to x's dtype
    as the JAX backward casts both before its weight-gradient products:
    [dWb; dWs] = dw_operand^T @ dout, summed over row tiles."""
    x32 = x.float()
    bases, _ = basis_ladder(x32, knots.float(), k)
    return torch.cat([x32 * torch.sigmoid(x32)] + bases, dim=1).to(x.dtype)


def kan_linear_bwd_plain(x, knots, wb, ws, dout, k):
    """The explicit analytic gradient: (dx, dwb, dws). dWb and dWs are
    summed over the JAX kernel's 128-row tiles in tile order, rounded to the
    weights' dtype after each tile (`_common.tiled_gram`)."""
    x32, d32, t32 = x.float(), dout.float(), knots.float()
    sig = torch.sigmoid(x32)
    D = x.shape[1]
    dw = tiled_gram(dw_operand(x, knots, k), d32, JAX_TILE, wb.dtype)
    dx = (d32 @ wb.float().T) * (sig * (1.0 + x32 * (1.0 - sig)))
    bases, pen = basis_ladder(x32, t32, k, keep_penultimate=True)
    dbasis = d32 @ ws.float().T
    for g in range(len(bases)):
        left = pen[g] * (1.0 / (t32[g + k] - t32[g]))[None, :]
        right = pen[g + 1] * (1.0 / (t32[g + k + 1] - t32[g + 1]))[None, :]
        dx = dx + dbasis[:, g * D:(g + 1) * D] * (k * (left - right))
    return dx.to(x.dtype), dw[:D], dw[D:]


def _grid_size(knots: torch.Tensor, k: int) -> int:
    g = knots.shape[0] - 2 * k - 1
    if k not in ORDERS or g not in GRIDS:
        raise ValueError(f"the B-spline kernels take spline order 1-4 and "
                         f"grid size 1-16; got spline order {k}, grid size {g}")
    return g


def _check_layer(x, knots, wb, ws, k):
    n, D = x.shape
    O = wb.shape[1]
    grid = _grid_size(knots, k)
    check_cuda("x", x, shape=(None, None))
    for name, t, shape in (("knots", knots, (2 * k + grid + 1, D)),
                           ("wb", wb, (D, O)), ("ws", ws, ((grid + k) * D, O))):
        check_cuda(name, t, x.dtype, shape)
    return n, D, O, grid


@functools.cache
def _fwd_fn(k: int, grid: int):
    P, I = _build.P, _build.I
    return _build.bind("bspline_fused", "bspline_fwd",
                       [P, P, P, P, P, I, I, I, I, I, I, P], (k, grid))


@functools.cache
def _dx_fn(k: int, grid: int):
    P, I = _build.P, _build.I
    return _build.bind("bspline_fused", "bspline_bwd_dx",
                       [P, P, P, P, P, P, P, I, I, I, I, I, I, I, P], (k, grid))


@functools.cache
def _dw_fn(k: int, grid: int):
    P, I = _build.P, _build.I
    return _build.bind("bspline_fused", "bspline_bwd_dw",
                       [P, P, P, P, P, I, I, I, I, I, I, I, P], (k, grid))


@functools.cache
def _side_stream(device) -> torch.cuda.Stream:
    """The second stream the backward runs its dx kernel on, one a device."""
    return torch.cuda.Stream(device)


def kan_linear_fwd(x, knots, wb, ws, k: int) -> torch.Tensor:
    """x (N, D), knots (K, D), wb (D, O), ws (n_basis*D, O), one dtype ->
    (N, O). On the card the library routes by dtype: bf16 to the
    tensor-core kernel (`bspline_fwd_mma_kernel`), f32 to the CUDA-core one
    (`bspline_fwd_kernel`); a shape neither takes raises."""
    if x.device.type == "cpu":
        return kan_linear_fwd_plain(x, knots, wb, ws, k)
    code = dtype_code(x)
    n, D, O, grid = _check_layer(x, knots, wb, ws, k)
    x, wb, ws = (aligned(t) for t in (x, wb, ws))  # staged with cp.async
    out = torch.empty((n, O), dtype=x.dtype, device=x.device)
    err = _fwd_fn(k, grid)(x.data_ptr(), knots.data_ptr(), wb.data_ptr(),
                    ws.data_ptr(), out.data_ptr(), n, D, O, grid, k, code,
                    stream_of(x))
    _build.check(err, "bspline_fwd")
    kan_linear_fwd.launches += 1
    return out


kan_linear_fwd.launches = 0


def _dx_f32_tiling(grid: int, k: int):
    """(rows a tile, outputs a staged weight tile, basis columns a chunk) of
    the f32 dx kernel (csrc/bspline_fused.cu `DxF32`)."""
    ng = grid + k + 1
    rpt = 8 if ng <= 9 else 4 if ng <= 14 else 2
    ac = ng * D_CHUNK
    return 8 * rpt, (O_TILE if ac <= 320 else 32), ac


def bwd_smem(width: int, grid: int, k: int, dtype) -> int:
    """Shared memory per block of the backward's largest kernel at its
    narrowest staging (csrc/bspline_fused.cu) for an output part of `width`
    (`bwd_parts`): under bf16 the dx kernel's 16-wide piece of the chunk
    weights beside two buffers of its 32-row dout (the part's outputs) and x
    tiles, and the dW kernel's basis beside a 64-wide part of its dout tile
    (both kernels take wider pieces where they fit); in f32 the dx kernel's
    rows of dout and one output tile of the chunk's weights (`DxF32`)."""
    rows, otx, ac = _dx_f32_tiling(grid, k)
    if dtype == torch.bfloat16:
        return max(2 * (ac * 24 + 2 * MMA_ROWS * (-(-width // 16) * 16 + 8)
                        + 2 * MMA_ROWS * X_PITCH),
                   2 * JAX_TILE * (ac + 8 + 64 + 8))
    return 4 * (rows * width + otx * (ac + 1))


def bwd_parts(O: int, grid: int, k: int, dtype):
    """(parts, width) of the backward's dx kernel: all O outputs in one part
    (width O, or O rounded up to 16 in bf16) where its staged dout rows fit
    in a block (every experiment script's shape), else the fewest parts of
    equal width (a multiple of 64 in f32, of 16 in bf16) that fit
    (csrc/bspline_fused.cu `launch_dx`: each part's share of dx goes to f32
    scratch, summed in order)."""
    step = 16 if dtype == torch.bfloat16 else O_TILE
    whole = -(-O // 16) * 16 if dtype == torch.bfloat16 else O
    if bwd_smem(whole, grid, k, dtype) <= SMEM_LIMIT:
        return 1, whole
    widest = step
    while bwd_smem(widest + step, grid, k, dtype) <= SMEM_LIMIT:
        widest += step
    per = -(-O // -(-O // widest))  # the outputs of each of the fewest parts
    width = -(-per // step) * step
    return -(-O // width), width


def kan_linear_bwd(x, knots, wb, ws, dout, k: int, need_dx: bool = True):
    """-> (dx or None, dwb (D, O), dws (n_basis*D, O)), in the inputs'
    dtype. dx is skipped when `need_dx` is False. dWb and dWs are summed
    over the JAX kernel's 128-row tiles in tile order (module docstring of
    csrc/bspline_fused.cu). Any O: the dx kernel takes wide outputs in parts
    (`bwd_parts`)."""
    if x.device.type == "cpu":
        dx, dwb, dws = kan_linear_bwd_plain(x, knots, wb, ws, dout, k)
        return (dx if need_dx else None), dwb, dws
    code = dtype_code(x)
    n, D, O, grid = _check_layer(x, knots, wb, ws, k)
    check_cuda("dout", dout, x.dtype, (n, O))
    x, wb, ws, dout = (aligned(t) for t in (x, wb, ws, dout))
    n_groups = grid + k + 1
    m = n_groups * D * O
    window = walk_window(-(-n // JAX_TILE), m, x.element_size())
    dx = torch.empty_like(x) if need_dx else None
    # the dx kernel's output parts' shares, when there are several
    parts, width = bwd_parts(O, grid, k, x.dtype)
    vbuf = (torch.empty((parts, n, D), dtype=torch.float32, device=x.device)
            if need_dx and parts > 1 else None)
    partial = torch.empty((window, m), dtype=x.dtype, device=x.device)
    dw = torch.empty((n_groups * D, O), dtype=x.dtype, device=x.device)
    # dx on a second stream beside the dW partials and their walk: they
    # share only their inputs; the caller's stream waits for both
    main = torch.cuda.current_stream(x.device)
    if dx is not None:
        side = _side_stream(x.device)
        side.wait_stream(main)
        err = _dx_fn(k, grid)(x.data_ptr(), knots.data_ptr(), wb.data_ptr(),
                       ws.data_ptr(), dout.data_ptr(), dx.data_ptr(),
                       None if vbuf is None else vbuf.data_ptr(), n, D, O,
                       width, grid, k, code, side.cuda_stream)
        _build.check(err, "bspline_bwd dx")
    err = _dw_fn(k, grid)(x.data_ptr(), knots.data_ptr(), dout.data_ptr(),
                   partial.data_ptr(), dw.data_ptr(), n, D, O, grid, k, code,
                   window, main.cuda_stream)
    if dx is not None:
        main.wait_stream(side)
    _build.check(err, "bspline_bwd")
    kan_linear_bwd.launches += 1
    return dx, dw[:D], dw[D:]


kan_linear_bwd.launches = 0


class BsplineKanMatmul(torch.autograd.Function):
    """KANLinear forward through the fused kernel, backward through the
    fused backward kernel (the JAX `bspline_kan_matmul` custom VJP)."""

    @staticmethod
    def forward(ctx, x, knots, wb, ws, k):
        ctx.save_for_backward(x, knots, wb, ws)
        ctx.k = k
        return kan_linear_fwd(x, knots, wb, ws, k)

    @staticmethod
    def backward(ctx, dout):
        x, knots, wb, ws = ctx.saved_tensors
        dx, dwb, dws = kan_linear_bwd(x, knots, wb, ws, dout.contiguous(),
                                      ctx.k, need_dx=ctx.needs_input_grad[0])
        return dx, None, dwb, dws, None


def weight_layouts(grid: torch.Tensor, base_weight: torch.Tensor,
                   scaled_spline_weight: torch.Tensor):
    """Module layouts -> kernel layouts: grid (D, K) -> knots (K, D);
    base_weight (O, D) -> (D, O); spline (O, D, n_basis) -> (n_basis*D, O)."""
    O, D, nb = scaled_spline_weight.shape
    knots = grid.t().contiguous()
    wb = base_weight.t().contiguous()
    ws = scaled_spline_weight.permute(2, 1, 0).reshape(nb * D, O)
    return knots, wb, ws.contiguous()


def kan_linear_fused(x: torch.Tensor, grid: torch.Tensor,
                     base_weight: torch.Tensor,
                     scaled_spline_weight: torch.Tensor,
                     spline_order: int) -> torch.Tensor:
    """Fused KANLinear forward from the module's layouts (the JAX
    `kan_linear_fused`)."""
    knots, wb, ws = weight_layouts(grid, base_weight, scaled_spline_weight)
    return BsplineKanMatmul.apply(x.contiguous(), knots, wb, ws,
                                  int(spline_order))
