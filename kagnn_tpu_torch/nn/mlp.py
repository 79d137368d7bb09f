"""MLP update and readout nets, the counterparts of `kagnn_tpu/nn/mlp.py`
(the reference's `make_mlp` helpers), with the reference's quirks:

  * hidden blocks are Linear -> ReLU (-> MaskedBatchNorm with batch_norm);
  * the final layer has no activation (the reference passes `nn.ReLU()` as
    the truthy `bias` argument of its last `nn.Linear`);
  * a single layer (hidden_layers < 2) is Linear -> ReLU, with no
    BatchNorm.

`TorchLinear` keeps torch's layout, `weight` (out, in) and `bias` (out,),
and torch's default init U(±1/sqrt(fan_in)) for both, drawn from the
caller's generator. Its product follows the JAX layer's promotion: the JAX
`x @ kernel` of a bf16 x with the f32 parameter is an f32 product, so a
bf16 input is cast exactly to f32 first and everything after it stays f32.
The product is `torch.matmul`, a plain dense product that the JAX package
leaves to XLA; it runs in full f32 (PyTorch's default: no TF32).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from kagnn_tpu_torch.ops.norm import MaskedBatchNorm
from kagnn_tpu_torch.utils.device import resolve_device


def _uniform(shape, bound: float, generator: torch.Generator) -> torch.Tensor:
    return (torch.rand(shape, generator=generator) * 2.0 - 1.0) * bound


class TorchLinear(nn.Module):
    """y = x @ weight.T + bias, in the promoted dtype of x and the f32
    weight. `bound` sets the weight's init range (default 1/sqrt(fan_in),
    torch's nn.Linear; `nn/convs.py::dense_transform` passes Glorot's)."""

    def __init__(self, in_features: int, out_features: int,
                 use_bias: bool = True, bound: Optional[float] = None,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        dev = resolve_device(device)
        gen = generator if generator is not None else torch.Generator().manual_seed(0)
        self.in_features, self.out_features = in_features, out_features
        torch_bound = 1.0 / math.sqrt(in_features)
        self.weight = nn.Parameter(_uniform(
            (out_features, in_features),
            torch_bound if bound is None else bound, gen).to(dev))
        self.bias = (nn.Parameter(_uniform((out_features,), torch_bound, gen).to(dev))
                     if use_bias else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(torch.promote_types(x.dtype, self.weight.dtype))
        y = torch.matmul(x, self.weight.T)
        return y if self.bias is None else y + self.bias


class MLP(nn.Module):
    """`make_mlp(num_features, hidden_dim, out_dim, hidden_layers,
    batch_norm)`; `forward(x, mask, train)` is the update-net calling
    convention of `GINConv` (`train` picks the BatchNorm's batch or running
    statistics; None follows the module's training flag)."""

    def __init__(self, num_features: int, hidden_dim: int, out_dim: int,
                 hidden_layers: int, batch_norm: bool = False,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        kw = dict(generator=generator, device=device)
        if hidden_layers >= 2:
            dims = [num_features] + [hidden_dim] * (hidden_layers - 1)
            self.layers = nn.ModuleList(
                TorchLinear(a, b, **kw) for a, b in zip(dims[:-1], dims[1:]))
            self.layers.append(TorchLinear(dims[-1], out_dim, **kw))
            self.norms = nn.ModuleList(
                MaskedBatchNorm(hidden_dim, device=device)
                for _ in range(hidden_layers - 1)) if batch_norm else None
        else:
            self.layers = nn.ModuleList([TorchLinear(num_features, out_dim, **kw)])
            self.norms = None
        self.single = hidden_layers < 2

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                train: Optional[bool] = None) -> torch.Tensor:
        if self.single:
            return torch.relu(self.layers[0](x))
        for i, layer in enumerate(self.layers[:-1]):
            x = torch.relu(layer(x))
            if self.norms is not None:
                x = self.norms[i](x, mask=mask, use_running_average=(
                    None if train is None else not train))
        return self.layers[-1](x)
