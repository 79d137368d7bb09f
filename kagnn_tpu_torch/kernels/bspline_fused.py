"""Fused B-spline KANLinear forward and backward: the port of
`kagnn_tpu/pallas/bspline_fused.py::_fwd_kernel` and `::_bwd_kernel`.

    out = SiLU(x) @ Wb + sum_g B_g(x) @ Ws_g

with the Cox–de Boor ladder built in f32 on per-feature knots (K, D), SiLU(x)
and the bases cast to the compute dtype before the products, and f32 sums.
The backward rebuilds the ladder from x and uses the analytic derivative
    dB_g/dx = k * (B^{k-1}_g / (t_{g+k} - t_g) - B^{k-1}_{g+1} / (t_{g+k+1} - t_{g+1})).

Layouts are the JAX kernel's: x (N, D), knots (K, D), wb (D, O) and the
spline weight flattened to ws (n_basis*D, O) with row g*D + d.

CUDA kernels: `csrc/bspline_fused.cu` (see its header for the bound on the
H100 and the design). On a CPU tensor the wrappers run the plain versions
below; on a CUDA tensor they launch the kernels or raise.
"""
from __future__ import annotations

import functools

import torch

from kagnn_tpu_torch.kernels import _build
from kagnn_tpu_torch.kernels._common import (SMEM_LIMIT, check_cuda,
                                             dtype_code, stream_of)

SUPPORTED = {(3, 3), (3, 4), (3, 5)}  # (spline order, grid size) compiled
D_CHUNK, O_TILE = 32, 64  # csrc/kan_common.cuh kDC, kOT
ROWS_PER_STEP = 32  # csrc/bspline_fused.cu kDwRows
DX_ROWS = 64  # csrc/bspline_fused.cu kDxRows


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


def kan_linear_bwd_plain(x, knots, wb, ws, dout, k):
    """The explicit analytic gradient: (dx, dwb, dws)."""
    x32, d32, t32 = x.float(), dout.float(), knots.float()
    sig = torch.sigmoid(x32)
    sx = (x32 * sig).to(x.dtype)
    dwb = (sx.float().T @ d32).to(wb.dtype)
    dx = (d32 @ wb.float().T) * (sig * (1.0 + x32 * (1.0 - sig)))
    bases, pen = basis_ladder(x32, t32, k, keep_penultimate=True)
    basis = torch.cat(bases, dim=1).to(x.dtype)
    dws = (basis.float().T @ d32).to(ws.dtype)
    dbasis = d32 @ ws.float().T
    D = x.shape[1]
    for g in range(len(bases)):
        left = pen[g] * (1.0 / (t32[g + k] - t32[g]))[None, :]
        right = pen[g + 1] * (1.0 / (t32[g + k + 1] - t32[g + 1]))[None, :]
        dx = dx + dbasis[:, g * D:(g + 1) * D] * (k * (left - right))
    return dx.to(x.dtype), dwb, dws


def _grid_size(knots: torch.Tensor, k: int) -> int:
    g = knots.shape[0] - 2 * k - 1
    if (k, g) not in SUPPORTED:
        raise ValueError(f"no CUDA kernel compiled for spline order {k}, grid "
                         f"size {g}; compiled: {sorted(SUPPORTED)}")
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
def _fwd_fn():
    P, I = _build.P, _build.I
    return _build.bind("bspline_fused", "bspline_fwd",
                       [P, P, P, P, P, I, I, I, I, I, I, P])


@functools.cache
def _bwd_fn():
    P, I = _build.P, _build.I
    return _build.bind("bspline_fused", "bspline_bwd",
                       [P, P, P, P, P, P, P, P, I, I, I, I, I, I, I, P])


def kan_linear_fwd(x, knots, wb, ws, k: int) -> torch.Tensor:
    """x (N, D), knots (K, D), wb (D, O), ws (n_basis*D, O), one dtype ->
    (N, O)."""
    if x.device.type == "cpu":
        return kan_linear_fwd_plain(x, knots, wb, ws, k)
    code = dtype_code(x)
    n, D, O, grid = _check_layer(x, knots, wb, ws, k)
    out = torch.empty((n, O), dtype=x.dtype, device=x.device)
    err = _fwd_fn()(x.data_ptr(), knots.data_ptr(), wb.data_ptr(),
                    ws.data_ptr(), out.data_ptr(), n, D, O, grid, k, code,
                    stream_of(x))
    _build.check(err, "bspline_fwd")
    kan_linear_fwd.launches += 1
    return out


kan_linear_fwd.launches = 0


def dw_splits(n: int, D: int, O: int, device) -> int:
    """Blocks that each own an f32 partial of dW: about two per SM in all."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    per_split = -(-D // D_CHUNK) * -(-O // O_TILE)
    tiles = max(1, -(-n // ROWS_PER_STEP))
    return max(1, min(tiles, (2 * sms) // per_split))


def kan_linear_bwd(x, knots, wb, ws, dout, k: int, need_dx: bool = True):
    """-> (dx or None, dwb (D, O), dws (n_basis*D, O)), in the inputs'
    dtype. dx is skipped when `need_dx` is False."""
    if x.device.type == "cpu":
        dx, dwb, dws = kan_linear_bwd_plain(x, knots, wb, ws, dout, k)
        return (dx if need_dx else None), dwb, dws
    code = dtype_code(x)
    n, D, O, grid = _check_layer(x, knots, wb, ws, k)
    # the dx kernel holds its rows' dout and one output tile of the chunk's
    # weights in shared memory
    smem = 4 * (DX_ROWS * O + O_TILE * ((grid + k + 1) * D_CHUNK + 1))
    if smem > SMEM_LIMIT:
        raise ValueError(f"backward of a layer with {O} outputs needs {smem} "
                         f"bytes of shared memory per block; the H100 gives "
                         f"{SMEM_LIMIT}")
    check_cuda("dout", dout, x.dtype, (n, O))
    splits = dw_splits(n, D, O, x.device)
    n_groups = grid + k + 1
    dx = torch.empty_like(x) if need_dx else None
    partial = torch.empty((splits, n_groups * D, O), dtype=torch.float32,
                          device=x.device)
    dw = torch.empty((n_groups * D, O), dtype=x.dtype, device=x.device)
    err = _bwd_fn()(x.data_ptr(), knots.data_ptr(), wb.data_ptr(),
                    ws.data_ptr(), dout.data_ptr(),
                    None if dx is None else dx.data_ptr(), partial.data_ptr(),
                    dw.data_ptr(), n, D, O, grid, k, code, splits,
                    stream_of(x))
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
