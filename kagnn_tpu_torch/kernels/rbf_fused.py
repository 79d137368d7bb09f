"""Fused RBF basis and spline product, forward and backward: the port of
`kagnn_tpu/pallas/rbf_fused.py::_fwd_kernel` and `::_bwd_kernel`
(`rbf_spline_matmul`, `fastkan_fused`).

    out = sum_g exp(-((x - c_g) * inv_h)^2) @ W_g

with G centers c_g from linspace(grid_min, grid_max, G) and inv_h = (G-1) /
(grid_max - grid_min). x (N, D) and the g-major spline weight w (G*D, O),
row g*D + d, are each f32 or bf16, independently; out, dout and dx are in
x's dtype, dW in w's. The FastKANLayer runs it when the layernorm or the
base update is off (kan/layers.py).

Rounding, as the JAX kernel has it in interpret mode (tests/test_torch_rbf.py):
  * with x in bf16 the distance is bf16 arithmetic: the centers
    c_0 + g * step and inv_h rounded to bf16, t = bf16(x - c_g),
    d = bf16(t * inv_h), bf16(d * d); exp in f32. The forward rounds the
    basis to bf16 before its product; the backward multiplies the f32 exp
    (XLA keeps the excess precision there). The derivative factor
    -2 * inv_h is the unrounded one;
  * products and sums in f32; dW is summed over the JAX kernel's row tiles
    (`dw_tile`) in tile order and rounded to w's dtype after each tile, as
    `dw_ref += partial.astype(dw.dtype)` does.

CUDA kernels: `csrc/rbf_fused.cu` (see its header for the bound on the H100
and the design; where w is bf16 the forward and the backward multiply on
the tensor cores, an f32 operand split into three bf16 terms, and where w
is f32 on the CUDA cores). The backward takes any O: its dx kernel cuts the
outputs into parts that fit in shared memory (`_bwd_plan`). On a CPU tensor
the wrappers run the plain versions below; on a CUDA tensor they launch the
kernels or raise.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from kagnn_tpu_torch.kernels import _build
from kagnn_tpu_torch.kernels._common import (aligned, check_cuda,
                                             dtype_code, dw_tile, stream_of,
                                             tiled_gram)
from kagnn_tpu_torch.kernels._common import round_to as _round
from kagnn_tpu_torch.kernels.fastkan_layer import (centers, g_major,
                                                   inv_h, num_grids_of)


def constants(grid_min: float, grid_max: float, num_grids: int, dtype):
    """(centers (G,) f32, inv_h) of the distance as the JAX kernel computes
    it for x of `dtype`: in f32 `kernels/fastkan_layer.py::centers`; in
    bf16 c_0 and the step rounded to bf16, then c_0 + g * step with each
    operation rounded, and inv_h rounded."""
    ih = inv_h(grid_min, grid_max, num_grids)
    if dtype == torch.float32:
        return torch.from_numpy(centers(grid_min, grid_max, num_grids)), ih
    lin = np.linspace(grid_min, grid_max, num_grids).astype(np.float32)
    step = float(lin[1] - lin[0]) if num_grids > 1 else 0.0

    def r(v):
        return _round(torch.as_tensor(v, dtype=torch.float32), dtype)

    g = torch.arange(num_grids, dtype=torch.float32)
    return r(r(float(lin[0])) + r(g * r(step))), float(r(ih))


def basis_plain(x: torch.Tensor, c: torch.Tensor, ih: float,
                round_exp: bool):
    """x (N, D) -> basis (N, G*D) f32 and scaled distance d (N, G*D),
    column g*D + d, with the rounding of x's dtype (module docstring)."""
    G, D = c.numel(), x.shape[1]
    t = _round(x.float().repeat(1, G) - c.to(x.device).repeat_interleave(D)[None, :],
               x.dtype)
    d = _round(t * ih, x.dtype)
    e = torch.exp(-_round(d * d, x.dtype))
    return (_round(e, x.dtype) if round_exp else e), d


def fwd_terms(x_dtype) -> int:
    """bf16 terms of each basis value in the tensor-core forward (w bf16;
    csrc/fastkan_fwd.cuh `kMmaTerms`): one for a bf16 x, whose basis is
    rounded to bf16; three for an f32 x, the value whole: its output is f32,
    and two terms (about 2^-17 of each value, the FastKAN forward's split up
    to 8 centers) read about 1.1 of the f32 bar against the JAX kernel at
    4-16 centers (tests/test_torch_rbf_terms.py)."""
    return 1 if x_dtype == torch.bfloat16 else 3


def rbf_spline_fwd_plain(x, w, grid_min: float, grid_max: float):
    c, ih = constants(grid_min, grid_max, num_grids_of(x, w), x.dtype)
    b, _ = basis_plain(x, c, ih, round_exp=True)
    return (b @ w.float()).to(x.dtype)


def rbf_spline_bwd_plain(x, w, dout, grid_min: float, grid_max: float,
                         need_dx: bool = True):
    """The explicit VJP of the JAX `_bwd_kernel`: (dx in x's dtype or None,
    dW in w's dtype)."""
    G, (n, D) = num_grids_of(x, w), x.shape
    c, ih = constants(grid_min, grid_max, G, x.dtype)
    b, d = basis_plain(x, c, ih, round_exp=False)
    d32 = dout.float()
    dx = None
    if need_dx:
        wide = (d32 @ w.float().T) * b * (-2.0 * inv_h(grid_min, grid_max, G)) * d
        dx = sum(wide[:, g * D:(g + 1) * D] for g in range(G)).to(x.dtype)
    return dx, tiled_gram(b, d32, dw_tile(n), w.dtype)


def check_rbf(x, w):
    """Shapes and types the kernels take -> (n, D, O, G)."""
    check_cuda("x", x, shape=(None, None))
    dtype_code(x)
    n, D = x.shape
    G = num_grids_of(x, w)
    if G < 2:
        raise ValueError(f"the RBF kernels take 2 or more centers, got {G}")
    check_cuda("w", w, shape=(G * D, None))
    dtype_code(w)
    if D == 0 or w.shape[1] == 0:
        raise ValueError(f"the RBF kernels take D, O >= 1, got ({D}, {w.shape[1]})")
    return n, D, w.shape[1], G


def _c_floats(t: torch.Tensor):
    return (ctypes.c_float * t.numel())(*t.tolist())


@functools.cache
def _fwd_fn(G: int):
    P, I, F = _build.P, _build.I, _build.F
    return _build.bind("rbf_fused", "rbf_fwd",
                       [P, P, P, I, I, I, I, P, F, I, I, P], (G,))


@functools.cache
def _bwd_fn(G: int):
    P, I, F = _build.P, _build.I, _build.F
    return _build.bind("rbf_fused", "rbf_bwd",
                       [P, P, P, P, P, P, P, I, I, I, I, P, F, F, I, I, I, P],
                       (G,))


@functools.lru_cache(maxsize=256)
def _bwd_plan(n: int, D: int, O: int, G: int, xcode: int, wcode: int) -> int:
    """The output parts of the backward's dx kernel (csrc/rbf_fused.cu
    `rbf_bwd_plan`): 1 unless the outputs' rows do not fit in a block."""
    P, I = _build.P, _build.I
    plan = (ctypes.c_int * 2)()
    fn = _build.bind("rbf_fused", "rbf_bwd_plan", [I, I, I, I, I, I, P], (G,))
    _build.check(fn(n, D, O, G, xcode, wcode, plan), "rbf_bwd_plan")
    return plan[0]


def rbf_spline_fwd(x, w, grid_min: float, grid_max: float) -> torch.Tensor:
    """x (N, D), w (G*D, O) g-major, each f32 or bf16 -> (N, O) in x's
    dtype."""
    if x.device.type == "cpu":
        return rbf_spline_fwd_plain(x, w, grid_min, grid_max)
    n, D, O, G = check_rbf(x, w)
    x, w = aligned(x), aligned(w)  # staged with cp.async where w is bf16
    c, ih = constants(grid_min, grid_max, G, x.dtype)
    out = torch.empty((n, O), dtype=x.dtype, device=x.device)
    err = _fwd_fn(G)(x.data_ptr(), w.data_ptr(), out.data_ptr(), n, D, O, G,
                    _c_floats(c), ih, dtype_code(x), dtype_code(w), stream_of(x))
    _build.check(err, "rbf_fwd")
    rbf_spline_fwd.launches += 1
    return out


rbf_spline_fwd.launches = 0


def rbf_spline_bwd(x, w, dout, grid_min: float, grid_max: float,
                   need_dx: bool = True):
    """-> (dx (N, D) in x's dtype or None, dW (G*D, O) in w's dtype). dx is
    skipped when `need_dx` is False."""
    if x.device.type == "cpu":
        return rbf_spline_bwd_plain(x, w, dout, grid_min, grid_max, need_dx)
    n, D, O, G = check_rbf(x, w)
    check_cuda("dout", dout, x.dtype, (n, O))
    x, w, dout = (aligned(t) for t in (x, w, dout))  # staged with cp.async
    xcode, wcode = dtype_code(x), dtype_code(w)
    c, ih = constants(grid_min, grid_max, G, x.dtype)
    tile = dw_tile(n)
    f32 = dict(dtype=torch.float32, device=x.device)
    partial = torch.empty((-(-n // tile), G * D * O), **f32)
    dw = torch.empty_like(w)
    dx = torch.empty_like(x) if need_dx else None
    # the dx kernel's output parts' shares, when there are several
    parts = _bwd_plan(n, D, O, G, xcode, wcode) if need_dx else 1
    vbuf = torch.empty((parts, n, D), **f32) if parts > 1 else None
    err = _bwd_fn(G)(x.data_ptr(), w.data_ptr(), dout.data_ptr(),
                    None if dx is None else dx.data_ptr(),
                    None if vbuf is None else vbuf.data_ptr(),
                    partial.data_ptr(), dw.data_ptr(), n, D, O, G,
                    _c_floats(c), ih,
                    -2.0 * inv_h(grid_min, grid_max, G), tile, xcode, wcode,
                    stream_of(x))
    _build.check(err, "rbf_bwd")
    rbf_spline_bwd.launches += 1
    return dx, dw


rbf_spline_bwd.launches = 0


class RbfSplineMatmul(torch.autograd.Function):
    """The JAX `rbf_spline_matmul` custom VJP: forward through the fused
    kernel, backward through the fused backward kernels."""

    @staticmethod
    def forward(ctx, x, w, grid_min, grid_max):
        ctx.save_for_backward(x, w)
        ctx.grid = (grid_min, grid_max)
        return rbf_spline_fwd(x, w, grid_min, grid_max)

    @staticmethod
    def backward(ctx, dout):
        x, w = ctx.saved_tensors
        dx, dw = rbf_spline_bwd(x, w, dout.contiguous(), *ctx.grid,
                                need_dx=ctx.needs_input_grad[0])
        return dx, dw, None, None


def fastkan_fused(xs: torch.Tensor, spline_weight: torch.Tensor,
                  grid_min: float, grid_max: float,
                  num_grids: int) -> torch.Tensor:
    """`rbf_basis(xs).reshape(N, -1) @ spline_weight.T` through the kernels,
    from the module's spline weight (O, D*G) (the JAX `fastkan_fused`)."""
    return RbfSplineMatmul.apply(xs.contiguous(), g_major(spline_weight, num_grids),
                                 float(grid_min), float(grid_max))
