"""B-spline basis evaluation, the counterpart of `kagnn_tpu/kan/bspline.py`
(`make_grid`, `b_splines`, `curve2coeff`). Shapes and conventions are the
JAX package's, which are the efficient-kan reference's."""
from __future__ import annotations

import torch


def make_grid(in_features: int, grid_size: int, spline_order: int,
              grid_range: tuple[float, float] = (-1.0, 1.0),
              device=None) -> torch.Tensor:
    """Uniform extended knot vector, shape (in_features, grid_size + 2*order + 1)."""
    lo, hi = grid_range
    h = (hi - lo) / grid_size
    pts = torch.arange(-spline_order, grid_size + spline_order + 1,
                       dtype=torch.float32, device=device)
    grid = pts * h + lo
    return grid.expand(in_features, grid.shape[0]).contiguous()


def b_splines(x: torch.Tensor, grid: torch.Tensor, spline_order: int) -> torch.Tensor:
    """x (batch, in), grid (in, K) -> (batch, in, K - 1 - order) bases
    (Cox–de Boor recursion, iterative)."""
    x = x.unsqueeze(-1)
    bases = ((x >= grid[:, :-1]) & (x < grid[:, 1:])).to(x.dtype)
    for k in range(1, spline_order + 1):
        left = (x - grid[:, : -(k + 1)]) / (grid[:, k:-1] - grid[:, : -(k + 1)])
        right = (grid[:, k + 1:] - x) / (grid[:, k + 1:] - grid[:, 1:-k])
        bases = left * bases[..., :-1] + right * bases[..., 1:]
    return bases


def curve2coeff(x: torch.Tensor, y: torch.Tensor, grid: torch.Tensor,
                spline_order: int) -> torch.Tensor:
    """Least-squares spline coefficients per in-feature.

    x (batch, in), y (batch, in, out) -> (out, in, grid_size + order)."""
    A = b_splines(x, grid, spline_order).transpose(0, 1)  # (in, B, C)
    B = y.transpose(0, 1)  # (in, B, out)
    # one batched solve over the in-features; "gelsd" is the SVD-based
    # LAPACK routine, as numpy's and JAX's lstsq use
    lapack = "gelsd" if A.device.type == "cpu" else None
    solution = torch.linalg.lstsq(A, B, driver=lapack).solution  # (in, C, out)
    return solution.permute(2, 0, 1).contiguous()
