"""Fused GCN aggregate: the port of `kagnn_tpu/pallas/gcn_agg.py::_kernel`
(forward) and `_ga_bwd`.

    out = dinv * (A @ hs + hs)

over the receiver CSR, with hs = h * dinv already carrying the sender-side
norm, the sum and the scale in f32 and the output in hs's dtype. dinv is
d^-1/2 with self-loops; it reaches the kernel as f32 and gets no gradient.
Padded edges point at the masked last row and are not masked.

The backward needs no kernel of its own (`_ga_bwd`):
    dd = dout * dinv (in dout's dtype),  dhs = A^T dd + dd
with A^T dd the segment-sum kernel over the sender CSR with the gather index
`receivers_by_sender` (kernels/spmm.py), so no (E, D) tensor is formed.

CUDA kernel: `csrc/gcn_agg.cu` (see its header for the bound on the H100 and
the design: rows of more than 64 in-edges are summed in pieces by separate
warps and combined in a fixed order). On a CPU tensor the wrapper runs the
plain version below; on a CUDA tensor it launches the kernel or raises.
"""
from __future__ import annotations

import functools

import torch

from kagnn_tpu_torch.kernels import _build
from kagnn_tpu_torch.kernels._common import (check_cuda, dtype_code,
                                             segment_ids, stream_of)
from kagnn_tpu_torch.kernels.spmm import sorted_segment_sum


def gcn_agg_plain(hs, dinv, senders, recv_row_ptr):
    """The plain version: gather + index_add_ into f32, the self term and
    the scale in f32, one cast."""
    agg = torch.zeros(hs.shape, dtype=torch.float32, device=hs.device)
    agg.index_add_(0, segment_ids(recv_row_ptr),
                   hs.index_select(0, senders.long()).float())
    return ((agg + hs.float()) * dinv.float()[:, None]).to(hs.dtype)


PIECE = 64  # csrc/gcn_agg.cu kPiece: edges per chunk of the row split


@functools.cache
def _fn():
    P, I = _build.P, _build.I
    return _build.bind("gcn_agg", "gcn_agg_fwd",
                       [P, P, P, P, P, P, P, I, I, I, I, P])


def gcn_agg_fwd(hs, dinv, senders, recv_row_ptr, receivers) -> torch.Tensor:
    """hs (N, D) f32/bf16, dinv (N,) f32, senders (E,) int32 in
    receiver-sorted order, recv_row_ptr (N+1,) int32, receivers (E,) int32
    (the row of each edge, which the kernel reads to find the rows it
    splits) -> (N, D) in hs's dtype."""
    if hs.device.type == "cpu":
        return gcn_agg_plain(hs, dinv, senders, recv_row_ptr)
    code = dtype_code(hs)
    check_cuda("hs", hs, shape=(None, None))
    n, d = hs.shape
    check_cuda("dinv", dinv, torch.float32, (n,))
    check_cuda("senders", senders, torch.int32, (None,))
    E = senders.numel()
    check_cuda("receivers", receivers, torch.int32, (E,))
    check_cuda("recv_row_ptr", recv_row_ptr, torch.int32, (n + 1,))
    out = torch.empty_like(hs)
    partial = torch.empty((2 * -(-E // PIECE), d), dtype=torch.float32,
                          device=hs.device)
    err = _fn()(hs.data_ptr(), dinv.data_ptr(), senders.data_ptr(),
                receivers.data_ptr(), recv_row_ptr.data_ptr(), out.data_ptr(),
                partial.data_ptr(), n, d, E, code, stream_of(hs))
    _build.check(err, "gcn_agg_fwd")
    gcn_agg_fwd.launches += 1
    return out


gcn_agg_fwd.launches = 0


class GcnAggregate(torch.autograd.Function):
    """The JAX `_gcn_agg` custom VJP: forward through the fused kernel, the
    backward as dd = dout * dinv and A^T dd + dd through the segment sum."""

    @staticmethod
    def forward(ctx, hs, dinv, g):
        ctx.save_for_backward(dinv)
        ctx.g = g
        return gcn_agg_fwd(hs, dinv, g.senders, g.recv_row_ptr, g.receivers)

    @staticmethod
    def backward(ctx, dout):
        (dinv,) = ctx.saved_tensors
        dd = (dout * dinv[:, None].to(dout.dtype)).contiguous()
        g = ctx.g
        dhs = sorted_segment_sum(dd, g.send_row_ptr, g.receivers_by_sender) + dd
        return dhs, None, None


def gcn_aggregate_fused(hs: torch.Tensor, g, dinv: torch.Tensor) -> torch.Tensor:
    """dinv ⊙ (A @ hs + hs) over a GraphBatch through the fused kernel."""
    return GcnAggregate.apply(hs.contiguous(), dinv.detach().float().contiguous(),
                              g)
