"""Fused FastKANLayer forward and backward: the port of
`kagnn_tpu/pallas/fastkan_layer.py::_fwd_kernel` and `::_bwd_kernel`.

    xs  = LayerNorm(x) * lng + lnb                 (f32 statistics, eps 1e-5)
    out = sum_g exp(-((xs - c_g) * inv_h)^2) @ W_g + SiLU(x) @ Wb + bb

with G centers c_g = linspace(grid_min, grid_max, G), inv_h = (G-1) /
(grid_max - grid_min), the basis and SiLU(x) kept in f32 before the products
(as the JAX kernel's `jnp.dot(f32 basis, W)`), f32 sums and the output in
x's dtype. The SiLU reads the raw x, not xs. The backward rebuilds every
intermediate from x alone and returns (dx, dlng, dlnb, dW, dWb, dbb).

Layouts are the JAX kernel's: x (N, D), lng/lnb (D,), the spline weight
g-major as w (G*D, O) with row g*D + d, wb (D, O), bb (O,), one dtype.
`fastkan_layer_fused` takes the module's layouts (spline weight (O, D*G)
with column d*G + g, base weight (O, D)) and maps them.

CUDA kernels: `csrc/fastkan_layer.cu` (see its header for the bound on the
H100 and the design: under bf16 the forward's and the backward's products
run on the tensor cores, each f32 basis value split into bf16 terms, and
the backward's dx kernels on a second stream beside its dW kernels), one
library per number of centers, built at its first use: any G >= 2, any D,
O up to the staged tiles' shared memory. The parameters are in x's dtype
or, beside an f32 x, bf16 (`_common.weight_dtype`: f32 products on the
widened parameters, their gradients walked in bf16). On a CPU tensor the
wrappers run the plain versions below; on a CUDA tensor they launch the
kernels or raise.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from kagnn_tpu_torch.kernels import _build
from kagnn_tpu_torch.kernels._common import (DTYPE_CODE, SMEM_LIMIT,
                                             aligned, check_cuda, dtype_code,
                                             dw_tile, stream_of, tiled_gram,
                                             walk_window, weight_dtype,
                                             widened)

LN_EPS = 1e-5


def centers(grid_min: float, grid_max: float, num_grids: int) -> np.ndarray:
    """The G centers as the JAX kernel builds them: linspace in f32, then
    c_0 + g * (c_1 - c_0) in f32 (`rbf_fused.py::_wide_basis`)."""
    c = np.linspace(grid_min, grid_max, num_grids).astype(np.float32)
    step = np.float32(c[1] - c[0]) if num_grids > 1 else np.float32(0.0)
    return (np.float32(c[0]) + np.arange(num_grids, dtype=np.float32) * step
            ).astype(np.float32)


def inv_h(grid_min: float, grid_max: float, num_grids: int) -> float:
    return float(1.0 / ((grid_max - grid_min) / (num_grids - 1)))


def wide_basis(xs32: torch.Tensor, c: torch.Tensor, ih: float):
    """(N, D) f32 -> basis (N, G*D) and scaled distance d (N, G*D), column
    g*D + d (g-major)."""
    G, D = c.numel(), xs32.shape[1]
    dist = (xs32.repeat(1, G) - c.repeat_interleave(D)[None, :]) * ih
    return torch.exp(-(dist * dist)), dist


def layer_norm_f32(x32: torch.Tensor):
    """(xhat, rstd) with two-pass f32 statistics (JAX `_ln_stats`)."""
    mu = x32.mean(1, keepdim=True)
    xc = x32 - mu
    rstd = torch.rsqrt((xc * xc).mean(1, keepdim=True) + LN_EPS)
    return xc * rstd, rstd


def num_grids_of(x, w) -> int:
    D = x.shape[1]
    G = w.shape[0] // max(D, 1)
    if G * D != w.shape[0]:
        raise ValueError(f"spline weight of shape {tuple(w.shape)} is not "
                         f"(G*{D}, O)")
    return G


def fastkan_forward_f32(x32, lng, lnb, w, wb, bb, grid_min, grid_max,
                        dtype) -> torch.Tensor:
    """Plain FastKANLayer forward of an f32 input, output in `dtype`
    (shared with the GIN kernel's plain version, which feeds the unrounded
    f32 aggregate)."""
    G = num_grids_of(x32, w)
    c = torch.from_numpy(centers(grid_min, grid_max, G)).to(x32.device)
    xhat, _ = layer_norm_f32(x32)
    xs = xhat * lng.float() + lnb.float()
    basis, _ = wide_basis(xs, c, inv_h(grid_min, grid_max, G))
    out = basis @ w.float()
    out = out + (x32 * torch.sigmoid(x32)) @ wb.float()
    return (out + bb.float()).to(dtype)


def fastkan_layer_fwd_plain(x, lng, lnb, w, wb, bb, grid_min, grid_max):
    return fastkan_forward_f32(x.float(), lng, lnb, w, wb, bb, grid_min,
                               grid_max, x.dtype)


def fastkan_bwd_terms(x, lng, lnb, w, dout, grid_min, grid_max):
    """(dx without the SiLU' term (N, D) f32, the weight gradients' factors):
    each gradient is a^T @ b summed over the JAX kernel's row tiles, for
    (a, b) in the order dlng, dlnb, dW, dWb, dbb: (1, dxs * xhat),
    (1, dxs), (basis, dout), (SiLU(x), dout), (1, dout), all f32."""
    G = num_grids_of(x, w)
    D = x.shape[1]
    ih = inv_h(grid_min, grid_max, G)
    c = torch.from_numpy(centers(grid_min, grid_max, G)).to(x.device)
    x32, d32, g32 = x.float(), dout.float(), lng.float()
    xhat, rstd = layer_norm_f32(x32)
    basis, dist = wide_basis(xhat * g32 + lnb.float(), c, ih)
    wide = (d32 @ w.float().T) * basis * (-2.0 * ih) * dist
    dxs = sum(wide[:, g * D:(g + 1) * D] for g in range(G))
    dxhat = dxs * g32
    m1 = dxhat.mean(1, keepdim=True)
    m2 = (dxhat * xhat).mean(1, keepdim=True)
    ones = torch.ones((x.shape[0], 1), device=x.device)
    return rstd * (dxhat - m1 - xhat * m2), [
        (ones, dxs * xhat), (ones, dxs), (basis, d32),
        (x32 * torch.sigmoid(x32), d32), (ones, d32)]


def fastkan_layer_bwd_plain(x, lng, lnb, w, wb, dout, grid_min, grid_max):
    """The explicit VJP of the JAX `_bwd_kernel`: (dx, dlng, dlnb, dw, dwb,
    dbb), each in its input's dtype (dbb in wb's). The weight gradients are
    summed over the JAX kernel's row tiles (`_common.dw_tile`) in tile
    order, rounded to their dtype after each tile (`_common.tiled_gram`)."""
    dx, terms = fastkan_bwd_terms(x, lng, lnb, w, dout, grid_min, grid_max)
    tile = dw_tile(x.shape[0])
    dlng, dlnb, dw, dwb, dbb = (tiled_gram(a, b, tile, t.dtype)
                                for (a, b), t in zip(terms, (lng, lnb, w, wb, wb)))
    x32, d32 = x.float(), dout.float()
    sig = torch.sigmoid(x32)
    dx = dx + (d32 @ wb.float().T) * (sig * (1.0 + x32 * (1.0 - sig)))
    return (dx.to(x.dtype), dlng[0], dlnb[0], dw, dwb, dbb[0])


def check_layer(x, lng, lnb, w, wb, bb=None):
    """Shapes and types the kernels take -> (n, D, O, G): the parameters
    all in x's dtype, or all bf16 beside an f32 x."""
    check_cuda("x", x, shape=(None, None))
    n, D = x.shape
    G = num_grids_of(x, w)
    if G < 2:
        raise ValueError(f"the FastKAN kernels take 2 or more centers, "
                         f"got {G}")
    O = w.shape[1]
    wdt = weight_dtype(x, w)
    for name, t, shape in (("lng", lng, (D,)), ("lnb", lnb, (D,)),
                           ("w", w, (G * D, O)), ("wb", wb, (D, O))):
        check_cuda(name, t, wdt, shape)
    if bb is not None:
        check_cuda("bb", bb, wdt, (O,))
    return n, D, O, G


@functools.lru_cache(maxsize=64)
def c_centers(grid_min, grid_max, G):
    """The centers as a ctypes float array (read on the host; made once per
    grid: a train step calls the layer kernels many times)."""
    return (ctypes.c_float * G)(*centers(grid_min, grid_max, G).tolist())


@functools.cache
def _fwd_fn(G: int):
    P, I, F = _build.P, _build.I, _build.F
    return _build.bind("fastkan_layer", "fastkan_fwd",
                       [P, P, P, P, P, P, P, I, I, I, I, P, F, I, P], (G,))


@functools.cache
def _bwd_fns(G: int):
    """(plan, stats, dx, dw) of the backward (csrc/fastkan_layer.cu)."""
    P, I, F = _build.P, _build.I, _build.F
    return (_build.bind("fastkan_layer", "fastkan_bwd_plan",
                        [I, I, I, I, I, P], (G,)),
            _build.bind("fastkan_layer", "fastkan_bwd_stats",
                        [P, P, I, I, I, I, P], (G,)),
            _build.bind("fastkan_layer", "fastkan_bwd_dx",
                        [P, P, P, P, P, P, P, P, P, P, P, P, I, I, I, I, P, F,
                         I, I, I, P], (G,)),
            _build.bind("fastkan_layer", "fastkan_bwd_dw",
                        [P, P, P, P, P, P, P, I, I, I, I, P, F, I, I, I, I, P],
                        (G,)))


@functools.lru_cache(maxsize=256)
def _bwd_plan(n: int, D: int, O: int, G: int, code: int):
    """(rows a piece, chunks, output parts) of the backward's dx kernels
    (csrc/fastkan_layer.cu `fastkan_bwd_plan`); raises where no output part
    fits a block."""
    plan = (ctypes.c_int * 4)()
    if _bwd_fns(G)[0](n, D, O, G, code, plan) != 0:
        raise ValueError(f"backward of a ({D}, {O}) layer with {G} centers: "
                         f"no output part of its dx kernels fits the "
                         f"{SMEM_LIMIT} bytes of shared memory of a block")
    return plan[0], plan[1], plan[2]


@functools.cache
def _side_stream(device) -> torch.cuda.Stream:
    """The second stream the backward runs its dx kernels on, one a
    device."""
    return torch.cuda.Stream(device)


def fastkan_layer_fwd(x, lng, lnb, w, wb, bb, grid_min: float,
                      grid_max: float) -> torch.Tensor:
    """x (N, D), lng/lnb (D,), w (G*D, O), wb (D, O), bb (O,), the
    parameters in x's dtype or bf16 beside an f32 x -> (N, O) in x's dtype.
    On the card the library routes by x's dtype: bf16 to the tensor-core
    kernel (`fastkan_fwd_mma_kernel`, the f32 basis as two or three bf16
    terms), f32 to the CUDA-core one (`fastkan_fwd_kernel`)."""
    if x.device.type == "cpu":
        return fastkan_layer_fwd_plain(x, lng, lnb, w, wb, bb, grid_min,
                                       grid_max)
    code = dtype_code(x)
    n, D, O, G = check_layer(x, lng, lnb, w, wb, bb)
    lng, lnb, w, wb, bb = widened(x, lng, lnb, w, wb, bb)
    x, w, wb = (aligned(t) for t in (x, w, wb))  # staged with cp.async
    out = torch.empty((n, O), dtype=x.dtype, device=x.device)
    err = _fwd_fn(G)(x.data_ptr(), lng.data_ptr(), lnb.data_ptr(),
                    w.data_ptr(), wb.data_ptr(), bb.data_ptr(),
                    out.data_ptr(), n, D, O, G,
                    c_centers(grid_min, grid_max, G),
                    inv_h(grid_min, grid_max, G), code, stream_of(x))
    _build.check(err, "fastkan_fwd")
    fastkan_layer_fwd.launches += 1
    return out


fastkan_layer_fwd.launches = 0


def fastkan_layer_bwd(x, lng, lnb, w, wb, dout, grid_min: float,
                      grid_max: float, need_dx: bool = True):
    """-> (dx or None in x's dtype, dlng (D,), dlnb (D,), dw (G*D, O),
    dwb (D, O), dbb (O,) in the parameters'). dx is skipped when `need_dx`
    is False."""
    if x.device.type == "cpu":
        dx, *rest = fastkan_layer_bwd_plain(x, lng, lnb, w, wb, dout,
                                            grid_min, grid_max)
        return (dx if need_dx else None, *rest)
    code = dtype_code(x)
    n, D, O, G = check_layer(x, lng, lnb, w, wb)
    check_cuda("dout", dout, x.dtype, (n, O))
    wdt = w.dtype
    lng, lnb, w, wb = widened(x, lng, lnb, w, wb)
    x, w, wb, dout = (aligned(t) for t in (x, w, wb, dout))
    _, stats_fn, dx_fn, dw_fn = _bwd_fns(G)
    rows, chunks, parts = _bwd_plan(n, D, O, G, code)
    tile = dw_tile(n)
    tiles = -(-n // tile)
    m_w = (G + 1) * D * O + O
    f32 = dict(dtype=torch.float32, device=x.device)
    # f32 scratch in one allocation, each piece 16-byte aligned (the kernels
    # stage `stats` with cp.async): the rows' statistics; the dx kernels'
    # row sums per (output part, chunk) and over all of them; their
    # dlng/dlnb per (piece of `rows` rows, part), then per row tile
    sizes = [2 * max(n, 1), (parts * chunks + 1) * n * 2 + 4,
             ((-(-n // rows)) * parts + tiles) * 2 * D]
    sizes = [-(-k // 4) * 4 for k in sizes]
    stats, mbuf, ln_partial = torch.empty(sum(sizes), **f32).split(sizes)
    # the output parts' shares of dx, when there are several
    vbuf = (torch.empty((parts, n, D), **f32) if need_dx and parts > 1
            else None)
    window = walk_window(tiles, m_w, x.element_size())
    w_partial = torch.empty((window, m_w), dtype=x.dtype, device=x.device)
    grads = torch.empty(m_w + 2 * D, dtype=wdt, device=x.device)
    dx = torch.empty_like(x) if need_dx else None
    c, ih = c_centers(grid_min, grid_max, G), inv_h(grid_min, grid_max, G)
    main = torch.cuda.current_stream(x.device)
    _build.check(stats_fn(x.data_ptr(), stats.data_ptr(), n, D, G, code,
                          main.cuda_stream), "fastkan_bwd stats")
    # dx and dlng/dlnb on a second stream beside the dW partials and their
    # walk: they share only their inputs and the row statistics; the
    # caller's stream waits for both
    side = _side_stream(x.device)
    side.wait_stream(main)
    err = dx_fn(x.data_ptr(), lng.data_ptr(), lnb.data_ptr(), w.data_ptr(),
                wb.data_ptr(), dout.data_ptr(), stats.data_ptr(),
                mbuf.data_ptr(), ln_partial.data_ptr(),
                None if vbuf is None else vbuf.data_ptr(),
                None if dx is None else dx.data_ptr(),
                grads[m_w:].data_ptr(), n, D, O, G, c, ih, code, DTYPE_CODE[wdt], tile,
                side.cuda_stream)
    _build.check(err, "fastkan_bwd dx")
    err = dw_fn(x.data_ptr(), lng.data_ptr(), lnb.data_ptr(),
                stats.data_ptr(), dout.data_ptr(), w_partial.data_ptr(),
                grads.data_ptr(), n, D, O, G, c, ih, code, DTYPE_CODE[wdt], tile, window,
                main.cuda_stream)
    main.wait_stream(side)
    _build.check(err, "fastkan_bwd dW")
    fastkan_layer_bwd.launches += 1
    dwb = grads[:D * O].view(D, O)
    dw = grads[D * O:(G + 1) * D * O].view(G * D, O)
    dbb = grads[(G + 1) * D * O:m_w]
    return dx, grads[m_w:m_w + D], grads[m_w + D:], dw, dwb, dbb


fastkan_layer_bwd.launches = 0


class FastKANLayerFn(torch.autograd.Function):
    """The JAX `_layer_core` custom VJP: forward through the fused kernel,
    backward through the fused backward kernel."""

    @staticmethod
    def forward(ctx, x, lng, lnb, w, wb, bb, grid_min, grid_max):
        ctx.save_for_backward(x, lng, lnb, w, wb)
        ctx.grid = (grid_min, grid_max)
        return fastkan_layer_fwd(x, lng, lnb, w, wb, bb, grid_min, grid_max)

    @staticmethod
    def backward(ctx, dout):
        x, lng, lnb, w, wb = ctx.saved_tensors
        grads = fastkan_layer_bwd(x, lng, lnb, w, wb, dout.contiguous(),
                                  *ctx.grid, need_dx=ctx.needs_input_grad[0])
        return (*grads, None, None)


def weight_layouts(ln_scale, ln_bias, spline_weight, base_weight, base_bias,
                   num_grids: int):
    """Module layouts -> kernel layouts: spline (O, D*G) with column d*G + g
    -> (G*D, O) with row g*D + d; base (O, D) -> (D, O)."""
    return (ln_scale.contiguous(), ln_bias.contiguous(),
            g_major(spline_weight, num_grids), base_weight.t().contiguous(),
            base_bias.contiguous())


def g_major(spline_weight: torch.Tensor, num_grids: int) -> torch.Tensor:
    """The module's spline weight (O, D*G), column d*G + g, as the kernels'
    (G*D, O), row g*D + d (contiguous)."""
    O = spline_weight.shape[0]
    D = spline_weight.shape[1] // num_grids
    return spline_weight.reshape(O, D, num_grids).permute(2, 1, 0).reshape(
        num_grids * D, O).contiguous()


def fastkan_layer_fused(x, ln_scale, ln_bias, spline_weight, base_weight,
                        base_bias, grid_min: float, grid_max: float,
                        num_grids: int) -> torch.Tensor:
    """Fused FastKANLayer (layernorm and base update on) from the module's
    layouts (the JAX `fastkan_layer_fused`)."""
    lng, lnb, w, wb, bb = weight_layouts(ln_scale, ln_bias, spline_weight,
                                         base_weight, base_bias, num_grids)
    return FastKANLayerFn.apply(x.contiguous(), lng, lnb, w, wb, bb,
                                float(grid_min), float(grid_max))
