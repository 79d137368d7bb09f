"""Masked BatchNorm on the card: the training forward and backward of
`ops/norm.py::MaskedBatchNorm` as one autograd Function over
`csrc/masked_bn.cu`. No TPU kernel corresponds: XLA fuses the JAX layer,
while PyTorch's eager path runs about 30 kernels a norm.

    forward:  per column, over the masked rows, the f32 mean and biased
              variance (n clamped to 1); a = w rsqrt(var + eps),
              b = bias - mean a; y = x a + b in x's dtype, zero on masked
              rows; the running buffers updated in place
    backward: g = m dy, xh = (x - mean) rstd; dbias = sum g,
              dw = sum g xh, dx = m w rstd (g - dbias/n - xh dw/n)

Three launches each way (a pass over the rows writing per-row-block
partials, a small kernel merging them in a fixed order, a pass writing y or
dx); no float atomics, so two runs give the same bits. The backward saves x,
the mask and the forward's statistics, no f32 copy of x.

The plain version is `MaskedBatchNorm.plain` (the CPU path, the halo path,
eval and the card tests' yardstick); the module routes through
`ops/norm.py::fused_route`. The wrapper takes CUDA tensors only and raises on
anything its kernels do not take.
"""
from __future__ import annotations

import functools
from typing import Optional

import torch

from kagnn_tpu_torch.kernels import _build
from kagnn_tpu_torch.kernels._common import check_cuda, dtype_code, stream_of


@functools.cache
def _fns():
    P, I, F = _build.P, _build.I, _build.F
    return {"row_blocks": _build.bind("masked_bn", "masked_bn_row_blocks", [I, I, I]),
            "fwd": _build.bind("masked_bn", "masked_bn_fwd",
                               [P, P, P, P, P, P, F, F, F, P, P, P, I, I, I, P]),
            "bwd": _build.bind("masked_bn", "masked_bn_bwd",
                               [P, P, P, P, P, P, P, P, P, I, I, I, P])}


@functools.cache
def _row_blocks(n: int, c: int, code: int) -> int:
    return _fns()["row_blocks"](n, c, code)


def _check_rows(x: torch.Tensor, mask: Optional[torch.Tensor]):
    """(n, c, dtype code, mask pointer) of x (n, c) f32/bf16 and its mask."""
    code = dtype_code(x)
    check_cuda("x", x, shape=(None, None))
    n, c = x.shape
    if c == 0:
        raise ValueError("masked_bn takes at least one column")
    if mask is not None:
        check_cuda("mask", mask, torch.bool, (n,))
    return n, c, code, (mask.data_ptr() if mask is not None else None)


class MaskedBatchNormFn(torch.autograd.Function):
    """The fused training forward and its backward. `buffers` is the pair
    (running_mean, running_var), updated in place by the forward."""

    @staticmethod
    def forward(ctx, x, mask, weight, bias, buffers, momentum, eps):
        n, c, code, mp = _check_rows(x, mask)
        running_mean, running_var = buffers
        for name, t in (("weight", weight), ("bias", bias),
                        ("running_mean", running_mean), ("running_var", running_var)):
            check_cuda(name, t, torch.float32, (c,))
        rb = _row_blocks(n, c, code)
        scratch = torch.empty((2 * c + 1) * rb, dtype=torch.float32, device=x.device)
        # a, b, mean, rstd (c each), then the clamped count
        stats = torch.empty(4 * c + 1, dtype=torch.float32, device=x.device)
        y = torch.empty_like(x)
        err = _fns()["fwd"](x.data_ptr(), mp, weight.data_ptr(), bias.data_ptr(),
                            running_mean.data_ptr(), running_var.data_ptr(),
                            1 - momentum, momentum, eps, scratch.data_ptr(),
                            stats.data_ptr(), y.data_ptr(), n, c, code, stream_of(x))
        _build.check(err, "masked_bn_fwd")
        masked_bn.launches += 1
        ctx.save_for_backward(x, mask, weight, stats)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, mask, weight, stats = ctx.saved_tensors
        n, c, code, mp = _check_rows(x, mask)
        dy = dy.contiguous()
        check_cuda("dy", dy, x.dtype, (n, c))
        rb = _row_blocks(n, c, code)
        scratch = torch.empty(2 * rb * c + 3 * c, dtype=torch.float32, device=x.device)
        dw = torch.empty(c, dtype=torch.float32, device=x.device)
        db = torch.empty(c, dtype=torch.float32, device=x.device)
        dx = torch.empty_like(x)
        err = _fns()["bwd"](x.data_ptr(), dy.data_ptr(), mp, weight.data_ptr(),
                            stats.data_ptr(), scratch.data_ptr(), dw.data_ptr(),
                            db.data_ptr(), dx.data_ptr(), n, c, code, stream_of(x))
        _build.check(err, "masked_bn_bwd")
        masked_bn.launches += 1
        return dx, None, dw, db, None, None, None


def masked_bn(x: torch.Tensor, mask: Optional[torch.Tensor], weight: torch.Tensor,
              bias: torch.Tensor, running_mean: torch.Tensor,
              running_var: torch.Tensor, momentum: float, eps: float) -> torch.Tensor:
    """MaskedBatchNorm's training forward on the card through the fused
    kernels; `launches` counts the forwards and the backwards."""
    return MaskedBatchNormFn.apply(
        x.contiguous(), None if mask is None else mask.contiguous(), weight.float(),
        bias.float(), (running_mean, running_var), float(momentum), float(eps))


masked_bn.launches = 0
