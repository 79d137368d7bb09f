"""Mask-aware BatchNorm, the counterpart of `kagnn_tpu/ops/norm.py`.

Statistics are taken in f32 over the masked (valid) rows only, with torch
BatchNorm1d semantics: momentum 0.1, eps 1e-5, the biased batch variance for
the normalisation and the unbiased one for the running update. Normalise
and affine fold into one FMA in the input dtype; masked rows come out zero.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from kagnn_tpu_torch.utils.device import resolve_device


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
        xf = x.float()
        if use_running_average is None:
            use_running_average = not self.training
        if use_running_average:
            mean, var = self.running_mean, self.running_var
        else:
            if mask is None:
                m = torch.ones((x.shape[0], 1), dtype=torch.float32,
                               device=x.device)
            else:
                m = mask.float()[:, None]
            n = m.sum().clamp_min(1.0)
            mean = (xf * m).sum(0) / n
            var = (((xf - mean) ** 2) * m).sum(0) / n
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
