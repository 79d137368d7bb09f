"""Gaussian radial-basis evaluation (the fastkan basis family), the
counterpart of `kagnn_tpu/kan/rbf.py`."""
from __future__ import annotations

import torch


def make_rbf_grid(grid_min: float, grid_max: float, num_grids: int,
                  device=None) -> torch.Tensor:
    """(num_grids,) f32 centers linspace(grid_min, grid_max, num_grids)."""
    return torch.linspace(grid_min, grid_max, num_grids, device=device)


def rbf_basis(x: torch.Tensor, grid: torch.Tensor,
              denominator: float) -> torch.Tensor:
    """exp(-((x[..., None] - grid) / denominator)^2): (..., D) ->
    (..., D, num_grids). The denominator takes x's dtype first, as a Python
    scalar does in jnp (bf16 for a bf16 x)."""
    den = torch.tensor(denominator, dtype=x.dtype, device=x.device)
    return torch.exp(-(((x[..., None] - grid) / den) ** 2))
