"""Mask-aware BatchNorm, the counterpart of `kagnn_tpu/ops/norm.py`.

Statistics are taken in f32 over the masked (valid) rows only, with torch
BatchNorm1d semantics: momentum 0.1, eps 1e-5, the biased batch variance for
the normalisation and the unbiased one for the running update. Normalise
and affine fold into one FMA in the input dtype; masked rows come out zero.
Under `ops.segment.halo_mode` the statistics are all-reduced over the
ranks, whose cotangents the all-reduce's backward carries back.

A training forward on the card (`fused_route`) runs the same arithmetic
through the hand-written kernels of `kernels/masked_bn.py`, three launches
each way; everything else (CPU tensors, other dtypes, the running averages,
halo mode) runs `MaskedBatchNorm.plain`, which is also the yardstick of the
kernels' tests.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from kagnn_tpu_torch.kernels.masked_bn import masked_bn
from kagnn_tpu_torch.ops import segment
from kagnn_tpu_torch.utils.device import resolve_device
from kagnn_tpu_torch.utils.profiling import NORM, span


def fused_route(x: torch.Tensor, batch_stats: bool) -> bool:
    """Whether a forward takes the fused kernels: batch statistics (not the
    running averages) of an f32 or bf16 x on the card, outside halo mode
    (whose statistics are all-reduced over the ranks)."""
    return (batch_stats and x.device.type == "cuda"
            and x.dtype in (torch.float32, torch.bfloat16)
            and segment.node_stats_axis() is None)


class MaskedBatchNorm(nn.Module):
    def __init__(self, num_features: int, momentum: float = 0.1,
                 epsilon: float = 1e-5, device=None):
        super().__init__()
        dev = resolve_device(device)
        self.momentum, self.epsilon = momentum, epsilon
        self.weight = nn.Parameter(torch.ones(num_features, device=dev))
        self.bias = nn.Parameter(torch.zeros(num_features, device=dev))
        self.register_buffer("running_mean", torch.zeros(num_features, device=dev))
        self.register_buffer("running_var", torch.ones(num_features, device=dev))

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                use_running_average: Optional[bool] = None) -> torch.Tensor:
        """`use_running_average` as the JAX layer's (None: not
        self.training)."""
        with span(NORM):
            if use_running_average is None:
                use_running_average = not self.training
            if fused_route(x, not use_running_average):
                return masked_bn(x, mask, self.weight, self.bias, self.running_mean,
                                 self.running_var, self.momentum, self.epsilon)
            return self.plain(x, mask, use_running_average)

    def plain(self, x: torch.Tensor, mask: Optional[torch.Tensor],
              use_running_average: bool) -> torch.Tensor:
        """The forward in PyTorch operations."""
        xf = x.float()
        if use_running_average:
            mean, var = self.running_mean, self.running_var
        else:
            # under halo_mode the node rows are sharded over the ranks: the
            # count, sums and squared deviations are all-reduced, so every
            # shard normalises with the global statistics (sync-BN)
            axis = segment.node_stats_axis()
            if mask is None:
                m = torch.ones((x.shape[0], 1), dtype=torch.float32,
                               device=x.device)
            else:
                m = mask.float()[:, None]
            n, s = m.sum(), (xf * m).sum(0)
            if axis is not None:
                n, s = segment.all_reduce(n, group=axis), segment.all_reduce_sum(s, axis)
            n = n.clamp_min(1.0)
            mean = s / n
            sq = (((xf - mean) ** 2) * m).sum(0)
            if axis is not None:
                sq = segment.all_reduce_sum(sq, axis)
            var = sq / n
            with torch.no_grad():
                unbiased = var * n / (n - 1.0).clamp_min(1.0)
                self.running_mean.mul_(1 - self.momentum).add_(self.momentum * mean)
                self.running_var.mul_(1 - self.momentum).add_(self.momentum * unbiased)
        a = self.weight * torch.rsqrt(var + self.epsilon)
        b = self.bias - mean * a
        y = x * a.to(x.dtype) + b.to(x.dtype)
        if mask is not None:
            y = torch.where(mask[:, None], y, torch.zeros((), dtype=y.dtype,
                                                          device=y.device))
        return y
