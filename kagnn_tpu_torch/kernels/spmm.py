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
over receiver-sorted edges, forward only, through `csrc/spmm_narrow.cu`:
the row pointer in one pass over the receivers (`narrow_row_ptr`), then a
thread a light row with wide loads, the rows of more than NARROW_PIECE
edges split at NARROW_PIECE-edge chunks and their pieces added in chunk
order (three launches, no atomics, deterministic).
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
    """The plain PyTorch version: index_select, then index_add_ into f32,
    of the entries [0, row_ptr[-1]) that the kernel walks."""
    n = row_ptr.numel() - 1
    rows = segment_ids(row_ptr)
    e = rows.numel()
    src = msgs[:e] if idx is None else msgs.index_select(0, idx[:e].long())
    out = torch.zeros((n,) + tuple(msgs.shape[1:]), dtype=torch.float32,
                      device=msgs.device)
    out.index_add_(0, rows, src.float())
    return out.to(msgs.dtype)


PIECE = 64  # csrc/spmm.cu kPiece: edges per chunk of the row split


def split_scratch(edges: int, d: int, device):
    """The scratch of the split row sum (csrc/kan_common.cuh; spmm, gin_fused
    and gin_fastkan) over `edges` edges of d columns: the heavy rows'
    pieces, two f32 slots of d a chunk of PIECE edges, and each chunk's first
    row (int32). `edges` is a count the host holds (the gather index's
    length), so that nothing waits for the device."""
    chunks = -(-edges // PIECE)
    return (torch.empty((2 * chunks, d), dtype=torch.float32, device=device),
            torch.empty((chunks,), dtype=torch.int32, device=device))


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
    out = torch.empty((n, d), dtype=msgs.dtype, device=msgs.device)
    partial, first_row = split_scratch(edges, d, msgs.device)
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
    JAX custom VJP (spmm.py `_vjp_bwd`); no kernel is needed for it. `ids`,
    the row of each message (the receivers for GINE's aggregate, node_graph
    for the pools), spares the backward rebuilding them from the row
    pointer, which on the card waits for the device (repeat_interleave
    reads the output's size)."""

    @staticmethod
    def forward(ctx, msgs, row_ptr, ids=None):
        ctx.save_for_backward(row_ptr if ids is None else ids)
        ctx.have_ids = ids is not None
        return sorted_segment_sum(msgs, row_ptr)

    @staticmethod
    def backward(ctx, cot):
        (rows,) = ctx.saved_tensors
        ids = rows if ctx.have_ids else segment_ids(rows)
        return cot.index_select(0, ids), None, None


NARROW_MAX_K = 8  # columns of the narrow segment sum (csrc/spmm_narrow.cu)
NARROW_PIECE = 64  # csrc/spmm_narrow.cu kPiece: rows of more edges are split


def narrow_row_ptr_plain(receivers: torch.Tensor, num_segments: int) -> torch.Tensor:
    """The row pointer (num_segments+1,) int32 of ascending receivers, as
    the JAX function's `block_starts` (searchsorted, side left): edges whose
    receiver is num_segments or more fall past the last row."""
    rows = torch.arange(num_segments + 1, dtype=receivers.dtype,
                        device=receivers.device)
    return torch.searchsorted(receivers, rows, out_int32=True)


@functools.cache
def _row_ptr_fn():
    P, I = _build.P, _build.I
    return _build.bind("spmm_narrow", "spmm_narrow_row_ptr", [P, P, I, I, P])


def narrow_row_ptr(receivers: torch.Tensor, num_segments: int) -> torch.Tensor:
    """`narrow_row_ptr_plain` on the card by one pass of
    `narrow_row_ptr_kernel` (a thread an edge writes the rows its receiver
    opens: exactly the searchsorted pointer); the plain version on a CPU
    tensor. `sorted_segment_sum_narrow` runs the same pass inside its own
    call (and counts it); this one times or checks it alone."""
    if receivers.device.type == "cpu":
        return narrow_row_ptr_plain(receivers, num_segments)
    check_cuda("receivers", receivers, torch.int32, (None,))
    row_ptr = torch.empty((num_segments + 1,), dtype=torch.int32,
                          device=receivers.device)
    _build.check(_row_ptr_fn()(receivers.data_ptr(), row_ptr.data_ptr(),
                               receivers.numel(), num_segments,
                               stream_of(receivers)), "spmm_narrow row_ptr")
    return row_ptr


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
    return _build.bind("spmm_narrow", "spmm_narrow",
                       [P, P, P, P, P, P, I, I, I, I, P])


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
    out = torch.empty((num_segments, k), dtype=vals.dtype, device=vals.device)
    # one scratch buffer (a call costs more host time than its kernels):
    # the row pointer, each chunk's first receiver, the pieces' f32 sums
    chunks = -(-e // NARROW_PIECE)
    scratch = torch.empty((num_segments + 1 + chunks + 2 * chunks * k,),
                          dtype=torch.int32, device=vals.device)
    row_ptr = scratch.data_ptr()
    first_row = row_ptr + 4 * (num_segments + 1)
    partial = first_row + 4 * chunks
    err = _narrow_fn()(vals.data_ptr(), receivers.data_ptr(), row_ptr,
                       out.data_ptr(), partial, first_row, e, num_segments, k,
                       code, stream_of(vals))
    _build.check(err, "spmm_narrow")
    sorted_segment_sum_narrow.launches += 1
    return out


sorted_segment_sum_narrow.launches = 0
