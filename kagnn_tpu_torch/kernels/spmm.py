"""Row-sorted CSR segment sum: the port of
`kagnn_tpu/pallas/spmm.py::_kernel` (`sorted_segment_sum`).

    out[r] = sum over e in [row_ptr[r], row_ptr[r+1]) of msgs[idx[e]]
             (msgs[e] when idx is None)

The sum is in f32 and the output in the messages' dtype, as in the TPU
kernel. On the main path it computes A^T·dz in every conv backward but the
first, over the sender CSR with `idx = receivers_by_sender`
(kernels/gin_fused.py), so the (E, D) cotangent tensor is never formed.

CUDA kernel: `csrc/spmm.cu` (bound by device-memory bytes): a row of at
most 64 edges is summed whole by a group of lanes with 16-byte loads, in
edge order; a heavier row (the receiver CSR's hub rows, or a pad row made
heavy by padding) is split into pieces at 64-edge chunks of the edge array
that separate warps sum, then added in chunk order. f32 sums, no atomics:
deterministic. On a CPU tensor the wrapper runs `sorted_segment_sum_plain`;
on a CUDA tensor it launches the kernel or raises.

`sorted_segment_sum_narrow` ports `spmm.py::_narrow_kernel` (the JAX
`sorted_segment_sum_narrow`): the segment sum of narrow (E, k <= 8) rows
over receiver-sorted edges, forward only, through `csrc/spmm_narrow.cu`
(a warp per row whose lanes split the row's edges).
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


PIECE = 64  # csrc/spmm.cu kPiece: edges per chunk of the row split


@functools.cache
def _fn():
    P, I = _build.P, _build.I
    return _build.bind("spmm", "spmm_csr", [P, P, P, P, P, P, I, I, I, I, P])


def sorted_segment_sum(msgs: torch.Tensor, row_ptr: torch.Tensor,
                       idx: Optional[torch.Tensor] = None) -> torch.Tensor:
    """msgs (M, D) f32/bf16, row_ptr (n+1,) int32 with row_ptr[0] == 0,
    idx (row_ptr[-1],) int32 or None (then M >= row_ptr[-1]) -> (n, D) in
    msgs' dtype."""
    if msgs.device.type == "cpu":
        return sorted_segment_sum_plain(msgs, row_ptr, idx)
    code = dtype_code(msgs)
    check_cuda("msgs", msgs, shape=(None, None))
    check_cuda("row_ptr", row_ptr, torch.int32, (None,))
    n, d = row_ptr.numel() - 1, msgs.shape[1]
    if idx is not None:
        check_cuda("idx", idx, torch.int32, (None,))
    # the edges' count bounds the chunks without reading row_ptr[-1] here
    edges = msgs.shape[0] if idx is None else idx.numel()
    chunks = -(-edges // PIECE)
    out = torch.empty((n, d), dtype=msgs.dtype, device=msgs.device)
    partial = torch.empty((2 * chunks, d), dtype=torch.float32, device=msgs.device)
    first_row = torch.empty((chunks,), dtype=torch.int32, device=msgs.device)
    err = _fn()(msgs.data_ptr(), row_ptr.data_ptr(),
                None if idx is None else idx.data_ptr(), out.data_ptr(),
                partial.data_ptr(), first_row.data_ptr(), n, d, edges, code,
                stream_of(msgs))
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


NARROW_MAX_K = 8  # columns of the narrow segment sum (csrc/spmm_narrow.cu)


def narrow_row_ptr(receivers: torch.Tensor, num_segments: int) -> torch.Tensor:
    """The row pointer (num_segments+1,) int32 of ascending receivers, as
    the JAX function's `block_starts` (searchsorted, side left): edges whose
    receiver is num_segments or more fall past the last row."""
    rows = torch.arange(num_segments + 1, dtype=receivers.dtype,
                        device=receivers.device)
    return torch.searchsorted(receivers, rows, out_int32=True)


def sorted_segment_sum_narrow_plain(vals: torch.Tensor, receivers: torch.Tensor,
                                    num_segments: int) -> torch.Tensor:
    """The plain PyTorch version: index_add_ into f32 of the edges whose
    receiver is a segment, then the values' dtype."""
    keep = (receivers >= 0) & (receivers < num_segments)
    out = torch.zeros((num_segments, vals.shape[1]), dtype=torch.float32,
                      device=vals.device)
    out.index_add_(0, receivers[keep].long(), vals[keep].float())
    return out.to(vals.dtype)


@functools.cache
def _narrow_fn():
    P, I = _build.P, _build.I
    return _build.bind("spmm_narrow", "spmm_narrow", [P, P, P, I, I, I, P])


def sorted_segment_sum_narrow(vals: torch.Tensor, receivers: torch.Tensor,
                              num_segments: int) -> torch.Tensor:
    """vals (E, k) f32/bf16 with k <= 8, receivers (E,) int32 ascending ->
    (num_segments, k) in vals' dtype, summed in f32. Forward only: the JAX
    function defines no VJP."""
    if vals.dim() != 2 or not 1 <= vals.shape[1] <= NARROW_MAX_K:
        raise ValueError(f"the narrow segment sum takes (E, k) values with "
                         f"1 <= k <= {NARROW_MAX_K}, got {tuple(vals.shape)}")
    if vals.device.type == "cpu":
        return sorted_segment_sum_narrow_plain(vals, receivers, num_segments)
    code = dtype_code(vals)
    e, k = vals.shape
    check_cuda("vals", vals)
    check_cuda("receivers", receivers, torch.int32, (e,))
    row_ptr = narrow_row_ptr(receivers, num_segments)
    out = torch.empty((num_segments, k), dtype=vals.dtype, device=vals.device)
    err = _narrow_fn()(vals.data_ptr(), row_ptr.data_ptr(), out.data_ptr(),
                       num_segments, k, code, stream_of(vals))
    _build.check(err, "spmm_narrow")
    sorted_segment_sum_narrow.launches += 1
    return out


sorted_segment_sum_narrow.launches = 0
