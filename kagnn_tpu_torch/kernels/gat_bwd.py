"""The two GAT backward kernels: the port of
`kagnn_tpu/pallas/gat_bwd.py::_dadst_kernel` (`gat_bwd_dadst`) and
`::_sender_kernel` (`gat_bwd_sender`).

Over the valid edges e = (s -> r), per head, with the forward's alpha and
S_r = sum_c dout_r * out_r (kernels/gat_fused.py):

    z_e  = asrc_s + adst_r
    w_e  = exp(min(leaky(z_e) - alpha_r, 80))
    dw_e = <dout_r, h_s>                    (f32 products and sum)
    dz_e = w_e (dw_e - S_r) leaky'(z_e)

    gat_dadst:  dadst_r = sum_{e -> r} dz_e                    (N, H) f32
    gat_sender: dh_s    = sum_{s -> e} w_e dout_r              (N, H*C) f32
                dasrc_s = sum_{s -> e} dz_e                    (N, H) f32

The first walks the receiver CSR with the gather index `senders`, the
second the sender CSR with `receivers_by_sender`. The +80 clamp is the JAX
kernels'. The self-loop terms are added by the caller. Padded edges take no
part.

CUDA kernels: `csrc/gat_bwd.cu` (see its header for the bound on the H100
and the design: gat_dadst splits a receiver row, gat_sender a sender row,
of more than GAT_PIECE = 64 valid edges into pieces, combined in chunk
order; gat_sender keeps the next round's receivers in flight beside each
round's gathers). On a CPU tensor the wrappers run the plain versions
below; on a CUDA tensor they launch the kernels or raise.
"""
from __future__ import annotations

import functools

import torch

from kagnn_tpu_torch.kernels import _build
from kagnn_tpu_torch.kernels._common import (check_cuda, check_gat, dleaky,
                                             dtype_code, gat_chunks, gat_edges,
                                             leaky, stream_of)

CLAMP = 80.0


def _edge_terms(h, asrc, adst, alpha, s, dout, src, dst, slope):
    """w_e (E, H) and dz_e (E, H) of the edges src -> dst."""
    heads = asrc.shape[1]
    z = asrc[src] + adst[dst]
    w = torch.exp(torch.clamp_max(leaky(z, slope) - alpha[dst], CLAMP))
    dw = (dout[dst].float() * h[src].float()).reshape(
        src.numel(), heads, -1).sum(2)
    return w, w * (dw - s[dst]) * dleaky(z, slope)


def gat_dadst_plain(h, asrc, adst, alpha, s, dout, senders, recv_row_ptr,
                    n_edge: int, slope: float):
    """The plain version: edge-space terms, index_add_ per receiver."""
    rcv, snd = gat_edges(recv_row_ptr, senders, n_edge)
    _, dz = _edge_terms(h, asrc, adst, alpha, s, dout, snd, rcv, slope)
    return torch.zeros_like(alpha).index_add_(0, rcv, dz)


def gat_sender_plain(h, asrc, adst, alpha, s, dout, receivers_by_sender,
                     send_row_ptr, n_edge: int, slope: float):
    """The plain version: edge-space terms, index_add_ per sender. Returns
    (dh (N, H*C) f32, dasrc (N, H) f32)."""
    snd, rcv = gat_edges(send_row_ptr, receivers_by_sender, n_edge)
    w, dz = _edge_terms(h, asrc, adst, alpha, s, dout, snd, rcv, slope)
    c = h.shape[1] // asrc.shape[1]
    dh = torch.zeros(h.shape, dtype=torch.float32, device=h.device)
    dh.index_add_(0, snd, w.repeat_interleave(c, 1) * dout[rcv].float())
    return dh, torch.zeros_like(alpha).index_add_(0, snd, dz)


def _check(h, asrc, adst, alpha, s, dout, idx, row_ptr):
    n, heads, c = check_gat(h, asrc, adst)
    for name, t in (("alpha", alpha), ("S", s)):
        check_cuda(name, t, torch.float32, (n, heads))
    check_cuda("dout", dout, h.dtype, tuple(h.shape))
    if c % 8 == 0 and dout.data_ptr() % 16:
        raise ValueError("dout must be 16-byte aligned")
    check_cuda("index", idx, torch.int32, (None,))
    check_cuda("row_ptr", row_ptr, torch.int32, (n + 1,))
    return n, heads, c


@functools.cache
def _dadst_fn():
    P, I, F = _build.P, _build.I, _build.F
    return _build.bind("gat_bwd", "gat_dadst",
                       [P, P, P, P, P, P, P, P, P, P, I, I, I, I, F, I, P])


@functools.cache
def _sender_fn():
    P, I, F = _build.P, _build.I, _build.F
    return _build.bind("gat_bwd", "gat_sender",
                       [P, P, P, P, P, P, P, P, P, P, P, I, I, I, I, F, I, P])


def sender_partial_width(heads: int, c: int) -> int:
    """Floats of a heavy sender row's piece partial (csrc/gat_bwd.cu): its
    H*C columns of dh, then its H of dasrc, rounded up to 16 bytes."""
    return -(-(heads * c + heads) // 4) * 4


def gat_dadst(h, asrc, adst, alpha, s, dout, senders, recv_row_ptr,
              n_edge: int, slope: float) -> torch.Tensor:
    """h, dout (N, H*C) f32/bf16; asrc, adst, alpha, S (N, H) f32; senders
    (E,) int32 receiver-sorted; recv_row_ptr (N+1,) int32 -> dadst (N, H)
    f32 over the edges (no self-loop term)."""
    if h.device.type == "cpu":
        return gat_dadst_plain(h, asrc, adst, alpha, s, dout, senders,
                               recv_row_ptr, n_edge, slope)
    code = dtype_code(h)
    n, heads, c = _check(h, asrc, adst, alpha, s, dout, senders, recv_row_ptr)
    out = torch.empty((n, heads), dtype=torch.float32, device=h.device)
    # the heavy rows' pieces (two slots of H values a chunk) and each
    # chunk's first row
    scratch = torch.empty(gat_chunks(n_edge) * (2 * heads + 1),
                          dtype=torch.float32, device=h.device)
    err = _dadst_fn()(h.data_ptr(), asrc.data_ptr(), adst.data_ptr(),
                      alpha.data_ptr(), s.data_ptr(), dout.data_ptr(),
                      senders.data_ptr(), recv_row_ptr.data_ptr(),
                      out.data_ptr(), scratch.data_ptr(), n, heads, c,
                      int(n_edge), float(slope), code, stream_of(h))
    _build.check(err, "gat_dadst")
    gat_dadst.launches += 1
    return out


gat_dadst.launches = 0


def gat_sender(h, asrc, adst, alpha, s, dout, receivers_by_sender,
               send_row_ptr, n_edge: int, slope: float):
    """As gat_dadst over the sender CSR (receivers_by_sender (E,) int32,
    send_row_ptr (N+1,) int32) -> (dh (N, H*C) f32, dasrc (N, H) f32) over
    the edges (no self-loop term)."""
    if h.device.type == "cpu":
        return gat_sender_plain(h, asrc, adst, alpha, s, dout,
                                receivers_by_sender, send_row_ptr, n_edge,
                                slope)
    code = dtype_code(h)
    n, heads, c = _check(h, asrc, adst, alpha, s, dout, receivers_by_sender,
                         send_row_ptr)
    dh = torch.empty(h.shape, dtype=torch.float32, device=h.device)
    dasrc = torch.empty((n, heads), dtype=torch.float32, device=h.device)
    # the heavy sender rows' pieces (two slots a chunk) and each chunk's
    # first row
    scratch = torch.empty(gat_chunks(n_edge) * (2 * sender_partial_width(heads, c) + 1),
                          dtype=torch.float32, device=h.device)
    err = _sender_fn()(h.data_ptr(), asrc.data_ptr(), adst.data_ptr(),
                       alpha.data_ptr(), s.data_ptr(), dout.data_ptr(),
                       receivers_by_sender.data_ptr(), send_row_ptr.data_ptr(),
                       dh.data_ptr(), dasrc.data_ptr(), scratch.data_ptr(), n,
                       heads, c, int(n_edge), float(slope), code, stream_of(h))
    _build.check(err, "gat_sender")
    gat_sender.launches += 1
    return dh, dasrc


gat_sender.launches = 0
