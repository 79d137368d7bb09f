"""Row-sorted CSR segment sum: the port of
`kagnn_tpu/pallas/spmm.py::_kernel` (`sorted_segment_sum`).

    out[r] = sum over e in [row_ptr[r], row_ptr[r+1]) of msgs[idx[e]]
             (msgs[e] when idx is None)

The sum is in f32 and the output in the messages' dtype, as in the TPU
kernel. On the main path it computes A^T·dz in every conv backward but the
first, over the sender CSR with `idx = receivers_by_sender`
(kernels/gin_fused.py), so the (E, D) cotangent tensor is never formed.

CUDA kernel: `csrc/spmm.cu` (one warp per row, f32 sum in registers, no
atomics: deterministic; bound by device-memory bytes). On a CPU tensor the
wrapper runs `sorted_segment_sum_plain`; on a CUDA tensor it launches the
kernel or raises.
"""
from __future__ import annotations

import functools
from typing import Optional

import torch

from kagnn_tpu_torch.kernels import _build
from kagnn_tpu_torch.kernels._common import (check_cuda, dtype_code,
                                             segment_ids, stream_of)


def sorted_segment_sum_plain(msgs: torch.Tensor, row_ptr: torch.Tensor,
                             idx: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The plain PyTorch version: index_select, then index_add_ into f32."""
    n = row_ptr.numel() - 1
    src = msgs if idx is None else msgs.index_select(0, idx.long())
    out = torch.zeros((n,) + tuple(msgs.shape[1:]), dtype=torch.float32,
                      device=msgs.device)
    out.index_add_(0, segment_ids(row_ptr), src.float())
    return out.to(msgs.dtype)


@functools.cache
def _fn():
    P, I = _build.P, _build.I
    return _build.bind("spmm", "spmm_csr", [P, P, P, P, I, I, I, P])


def sorted_segment_sum(msgs: torch.Tensor, row_ptr: torch.Tensor,
                       idx: Optional[torch.Tensor] = None) -> torch.Tensor:
    """msgs (M, D) f32/bf16, row_ptr (n+1,) int32, idx (row_ptr[-1],) int32
    or None -> (n, D) in msgs' dtype."""
    if msgs.device.type == "cpu":
        return sorted_segment_sum_plain(msgs, row_ptr, idx)
    code = dtype_code(msgs)
    check_cuda("msgs", msgs, shape=(None, None))
    check_cuda("row_ptr", row_ptr, torch.int32, (None,))
    n, d = row_ptr.numel() - 1, msgs.shape[1]
    if idx is not None:
        check_cuda("idx", idx, torch.int32, (None,))
    out = torch.empty((n, d), dtype=msgs.dtype, device=msgs.device)
    err = _fn()(msgs.data_ptr(), row_ptr.data_ptr(),
                None if idx is None else idx.data_ptr(), out.data_ptr(),
                n, d, code, stream_of(msgs))
    _build.check(err, "spmm_csr")
    sorted_segment_sum.launches += 1
    return out


sorted_segment_sum.launches = 0


class SortedSegmentSum(torch.autograd.Function):
    """Differentiable `sorted_segment_sum` over receiver-sorted messages.
    Its VJP is the gather of the cotangent at each edge's row, as in the
    JAX custom VJP (spmm.py `_vjp_bwd`); no kernel is needed for it."""

    @staticmethod
    def forward(ctx, msgs, row_ptr):
        ctx.save_for_backward(row_ptr)
        return sorted_segment_sum(msgs, row_ptr)

    @staticmethod
    def backward(ctx, cot):
        (row_ptr,) = ctx.saved_tensors
        return cot.index_select(0, segment_ids(row_ptr)), None
