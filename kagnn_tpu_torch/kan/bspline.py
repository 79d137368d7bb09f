"""B-spline basis evaluation, the counterpart of `kagnn_tpu/kan/bspline.py`
(`make_grid`, `b_splines`, `curve2coeff`, `update_grid`). Shapes and
conventions are the JAX package's, which are the efficient-kan reference's.

The least-squares fits return the minimum-norm solution that JAX's
`jnp.linalg.lstsq` returns (singular values below eps * max(M, N) of the
largest count as zero) on every device: a grid adapted to tied samples, or
to a sampled batch's zero pad rows, leaves bases with no sample and the
system rank-deficient."""
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
    return lstsq(A, B).permute(2, 0, 1).contiguous()  # one batched solve


def lstsq(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """The minimum-norm least-squares solution X of A X = B, batched over
    the leading dimension, with JAX's cutoff: singular values below
    eps * max(M, N) times the largest count as zero. On the CPU LAPACK's
    SVD-based `gelsd` (the same cutoff, relative to the largest singular
    value); on the card the SVD on the device, X = V diag(1/s) U^T B, which
    is how `jnp.linalg.lstsq` computes it. Never `gels`, the only driver
    torch.linalg.lstsq has on CUDA: a QR solve that assumes full column
    rank and returns garbage without it."""
    if A.device.type == "cpu":
        return torch.linalg.lstsq(A, B, driver="gelsd").solution
    return lstsq_svd(A, B)


def lstsq_svd(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """`lstsq` through the SVD on A's device, as `jnp.linalg.lstsq`
    computes it (the card's solve; callable on the CPU too)."""
    U, S, Vh = torch.linalg.svd(A, full_matrices=False)
    rcond = torch.finfo(A.dtype).eps * max(A.shape[-2:])
    keep = S >= rcond * S[..., :1]
    s_inv = torch.where(keep, 1.0 / torch.where(keep, S, torch.ones_like(S)),
                        torch.zeros_like(S))
    return Vh.mT @ (s_inv[..., None] * (U.mT @ B))


def update_grid(x: torch.Tensor, grid: torch.Tensor,
                spline_weight: torch.Tensor,
                spline_scaler: torch.Tensor | None, grid_size: int,
                spline_order: int, grid_eps: float = 0.02,
                margin: float = 0.01) -> tuple[torch.Tensor, torch.Tensor]:
    """Adapt the knot vector to the empirical distribution of `x` (batch,
    in) and refit the spline coefficients to the function the layer's
    scaled splines represent (reference ekan.py:164-211, the JAX
    `update_grid` step for step). Returns (new_grid (in, K), new
    spline_weight (out, in, grid_size + order)); the new weight fits the
    SCALED splines, as the reference's and the JAX update do."""
    batch = x.shape[0]
    splines = b_splines(x, grid, spline_order).transpose(0, 1)  # (in, B, C)
    scaled = spline_weight if spline_scaler is None else (
        spline_weight * spline_scaler[..., None])
    coeff = scaled.permute(1, 2, 0)  # (in, C, out)
    unreduced = torch.bmm(splines, coeff).transpose(0, 1)  # (B, in, out)

    x_sorted = torch.sort(x, dim=0).values
    # jnp.linspace(0, batch - 1, grid_size + 1).astype(int32): the f32
    # fractions times the last index, truncated
    frac = torch.arange(grid_size + 1, dtype=torch.float32) / grid_size
    idx = ((batch - 1) * frac).to(torch.int64).to(x.device)
    grid_adaptive = x_sorted[idx]
    uniform_step = (x_sorted[-1] - x_sorted[0] + 2 * margin) / grid_size
    grid_uniform = (torch.arange(grid_size + 1, dtype=x.dtype,
                                 device=x.device)[:, None] * uniform_step
                    + x_sorted[0] - margin)
    new_grid = grid_eps * grid_uniform + (1 - grid_eps) * grid_adaptive
    steps = torch.arange(1, spline_order + 1, dtype=x.dtype, device=x.device)
    lower = new_grid[:1] - uniform_step * steps.flip(0)[:, None]
    upper = new_grid[-1:] + uniform_step * steps[:, None]
    new_grid = torch.cat([lower, new_grid, upper], dim=0).T.contiguous()
    return new_grid, curve2coeff(x, unreduced, new_grid, spline_order)
