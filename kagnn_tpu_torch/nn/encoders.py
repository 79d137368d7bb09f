"""OGB-style categorical input encoders for molecular graphs, the
counterparts of `kagnn_tpu/nn/encoders.py` (`CategoricalSumEncoder`,
`AtomEncoder`, `BondEncoder`, the vocab sizes of the reference's
`allowable_features`).

Each feature column has its own embedding table (vocab, emb_dim),
Xavier-uniform from the caller's generator; the rows are summed in f32.
Two JAX behaviours are copied:

  * an index is clipped to its table (`clip(idx, 0, vocab - 1)`);
  * table i reads column i, and jnp clamps a static column index past the
    input's last column to that last column, so on one-column input (ZINC's
    atoms and the synthetic molecules) every table reads column 0. Here
    table i reads column min(i, n_cols - 1).

The embedding sums stay plain torch (a gather and its index_add backward).
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn

from kagnn_tpu_torch.utils.device import resolve_device

ATOM_FEATURE_DIMS: tuple[int, ...] = (119, 5, 12, 12, 10, 6, 6, 2, 2)
BOND_FEATURE_DIMS: tuple[int, ...] = (5, 6, 2)


class CategoricalSumEncoder(nn.Module):
    """Sum of per-column embeddings: x (N, n_cols) integer -> (N, emb_dim)
    f32. Tables `emb.{i}` (vocab_i, emb_dim)."""

    def __init__(self, feature_dims: Sequence[int], emb_dim: int,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        dev = resolve_device(device)
        gen = generator if generator is not None else torch.Generator().manual_seed(0)
        self.feature_dims, self.emb_dim = tuple(feature_dims), emb_dim
        tables = []
        for dim in self.feature_dims:
            bound = math.sqrt(6.0 / (dim + emb_dim))  # xavier_uniform
            w = (torch.rand((dim, emb_dim), generator=gen) * 2.0 - 1.0) * bound
            tables.append(nn.Parameter(w.to(dev)))
        self.emb = nn.ParameterList(tables)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = torch.zeros((x.shape[0], self.emb_dim), dtype=torch.float32,
                          device=x.device)
        last = x.shape[1] - 1
        for i, (dim, table) in enumerate(zip(self.feature_dims, self.emb)):
            idx = x[:, min(i, last)].to(torch.int32).clamp(0, dim - 1)
            out = out + table.index_select(0, idx.long())
        return out


class AtomEncoder(CategoricalSumEncoder):
    def __init__(self, emb_dim: int,
                 feature_dims: Sequence[int] = ATOM_FEATURE_DIMS, **kw):
        super().__init__(feature_dims, emb_dim, **kw)


class BondEncoder(CategoricalSumEncoder):
    def __init__(self, emb_dim: int,
                 feature_dims: Sequence[int] = BOND_FEATURE_DIMS, **kw):
        super().__init__(feature_dims, emb_dim, **kw)
