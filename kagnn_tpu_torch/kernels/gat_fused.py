"""Fused GAT attention forward and its custom VJP: the port of
`kagnn_tpu/pallas/gat_fused.py::_kernel` (`_fwd_impl`) and `_gat_attn`.

Per receiver r and head, over the valid edges e -> r and the implicit
self-loop (with l_self = leaky(asrc_r + adst_r)):

    l_e   = leaky(asrc[s_e] + adst_r)
    m_r   = bf16(max(l_self, max_e l_e))        the shift, bf16-rounded
    den_r = exp(l_self - m_r) + sum_e exp(l_e - m_r)
    out_r = (exp(l_self - m_r) h_r + sum_e T(exp(l_e - m_r)) h[s_e]) / den_r
    alpha_r = m_r + log(den_r)

with T the rounding to h's dtype (the JAX kernel's weighted products take
the weights in the messages' dtype), f32 sums, out in h's dtype and alpha
(the log-normaliser) in f32. The rounded shift is the JAX kernel's; its
online softmax raises the shift chunk by chunk, the port takes the row's
max in a first pass, which gives the same final shift (bf16 rounding is
monotone) and differs only in f32 rounding. Padded edges take no part.

The backward (`_ga_bwd`) needs no softmax machinery: with
S_r = sum_c dout_r * out_r per head (the product in h's dtype, the sum in
f32) and w_e = exp(l_e - alpha_r), dl_e = w_e (dw_e - S_r) with
dw_e = <dout_r, h[s_e]> per head, dz_e = dl_e leaky'(z_e); the kernels of
kernels/gat_bwd.py sum dz_e per receiver (dadst) and w_e dout_r, dz_e per
sender (dh, dasrc); the self-loop terms are node-space PyTorch here.

CUDA kernels: `csrc/gat_fused.cu` (see its header for the bound on the
H100 and the design: a receiver row of more than GAT_PIECE = 64 valid edges
is split into pieces that separate warps sum with the row's one shift, and
combined in chunk order; three launches, no host sync). On a CPU tensor the
wrapper runs the plain version below; on a CUDA tensor it launches the
kernels or raises.
"""
from __future__ import annotations

import functools

import torch

from kagnn_tpu_torch.kernels import _build
from kagnn_tpu_torch.kernels._common import (check_cuda, check_gat, dleaky,
                                             dtype_code, gat_chunks, gat_edges,
                                             leaky, stream_of)
from kagnn_tpu_torch.kernels.gat_bwd import gat_dadst, gat_sender


def gat_fwd_plain(h, asrc, adst, senders, recv_row_ptr, n_edge: int,
                  slope: float):
    """The plain version: the row max by scatter_reduce, the sums by
    index_add_ into f32. Returns (out (N, H*C) in h's dtype, alpha (N, H)
    f32)."""
    n, hc = h.shape
    heads = asrc.shape[1]
    c = hc // heads
    rcv, snd = gat_edges(recv_row_ptr, senders, n_edge)
    a_s, a_d = asrc.float(), adst.float()
    sl = leaky(a_s + a_d, slope)
    lg = leaky(a_s[snd] + a_d[rcv], slope)
    mx = sl.scatter_reduce(0, rcv[:, None].expand(-1, heads), lg, "amax")
    mx = mx.to(torch.bfloat16).float()
    es = torch.exp(sl - mx)
    w = torch.exp(lg - mx[rcv])
    den = es.index_add(0, rcv, w)
    wq = w.to(h.dtype).float()
    acc = es.repeat_interleave(c, 1) * h.float()
    acc.index_add_(0, rcv, wq.repeat_interleave(c, 1) * h[snd].float())
    out = (acc / den.repeat_interleave(c, 1)).to(h.dtype)
    return out, mx + torch.log(den)


@functools.cache
def _fn():
    P, I, F = _build.P, _build.I, _build.F
    return _build.bind("gat_fused", "gat_fwd",
                       [P, P, P, P, P, P, P, P, I, I, I, I, F, I, P])


def scratch_floats(n_edge: int, heads: int, c: int) -> int:
    """f32 values of the forward's scratch: per piece slot (two a chunk)
    the numerator (H*C), the piece's max (H) and denominator (H); per chunk
    its first and last row."""
    return 2 * gat_chunks(n_edge) * (heads * c + 2 * heads + 1)


def gat_fwd(h, asrc, adst, senders, recv_row_ptr, n_edge: int, slope: float):
    """h (N, H*C) f32/bf16, asrc/adst (N, H) f32, senders (E,) int32 in
    receiver-sorted order, recv_row_ptr (N+1,) int32, n_edge valid edges ->
    (out (N, H*C) in h's dtype, alpha (N, H) f32)."""
    if h.device.type == "cpu":
        return gat_fwd_plain(h, asrc, adst, senders, recv_row_ptr, n_edge,
                             slope)
    code = dtype_code(h)
    n, heads, c = check_gat(h, asrc, adst)
    check_cuda("senders", senders, torch.int32, (None,))
    check_cuda("recv_row_ptr", recv_row_ptr, torch.int32, (n + 1,))
    out = torch.empty_like(h)
    alpha = torch.empty((n, heads), dtype=torch.float32, device=h.device)
    scratch = torch.empty(scratch_floats(n_edge, heads, c), dtype=torch.float32,
                          device=h.device)
    err = _fn()(h.data_ptr(), asrc.data_ptr(), adst.data_ptr(),
                senders.data_ptr(), recv_row_ptr.data_ptr(), out.data_ptr(),
                alpha.data_ptr(), scratch.data_ptr(), n, heads, c, int(n_edge),
                float(slope), code, stream_of(h))
    _build.check(err, "gat_fwd")
    gat_fwd.launches += 1
    return out, alpha


gat_fwd.launches = 0


def _head_sum(x: torch.Tensor, heads: int) -> torch.Tensor:
    """(N, H*C) -> (N, H) in f32."""
    return x.float().reshape(x.shape[0], heads, -1).sum(2)


class GatAttention(torch.autograd.Function):
    """The JAX `_gat_attn` custom VJP: forward through the gat_fwd kernel,
    backward through the dadst and sender kernels plus the self-loop terms
    in node space. `ak` is the asrc the kernels read (asrc rounded to h's
    dtype when it is not h's own product, as the JAX kernel's augmented
    lanes round it); the self terms of the backward read asrc itself, as
    the JAX backward does. No gradient for `ak` itself: asrc's sensitivity
    flows through `asrc`, as the JAX VJP gives att_src_matrix none."""

    @staticmethod
    def forward(ctx, h, asrc, adst, ak, g, slope):
        out, alpha = gat_fwd(h, ak, adst, g.senders, g.recv_row_ptr,
                             g.n_edge, slope)
        ctx.save_for_backward(h, asrc, adst, ak, out, alpha)
        ctx.g, ctx.slope = g, slope
        return out

    @staticmethod
    def backward(ctx, dout):
        h, asrc, adst, ak, out, alpha = ctx.saved_tensors
        g, slope = ctx.g, ctx.slope
        heads = asrc.shape[1]
        c = h.shape[1] // heads
        dout = dout.to(h.dtype).contiguous()
        s = _head_sum(dout * out, heads).contiguous()
        dadst_e = gat_dadst(h, ak, adst, alpha, s, dout, g.senders,
                            g.recv_row_ptr, g.n_edge, slope)
        dh_msgs, dasrc_e = gat_sender(h, ak, adst, alpha, s, dout,
                                      g.receivers_by_sender, g.send_row_ptr,
                                      g.n_edge, slope)
        zs = asrc + adst
        w_self = torch.exp(leaky(zs, slope) - alpha)
        dz_self = w_self * (_head_sum(dout * h, heads) - s) * dleaky(zs, slope)
        dh = (dh_msgs + w_self.repeat_interleave(c, 1) * dout.float()
              ).to(h.dtype)
        return dh, dasrc_e + dz_self, dadst_e + dz_self, None, None, None


def gat_attention_fused(h: torch.Tensor, asrc: torch.Tensor,
                        adst: torch.Tensor, g, negative_slope: float = 0.2,
                        att_src_matrix=None) -> torch.Tensor:
    """The GAT attention block over a GraphBatch through the kernels (the
    JAX `gat_attention_fused`). asrc and adst reach the kernels as f32; when
    `att_src_matrix` is None, asrc is rounded to h's dtype first, as the
    JAX kernel carries a free-standing asrc in the message lanes."""
    asrc = asrc.float().contiguous()
    ak = asrc.detach()
    if att_src_matrix is None:
        ak = ak.to(h.dtype).float()
    return GatAttention.apply(h.contiguous(), asrc, adst.float().contiguous(),
                              ak.contiguous(), g, float(negative_slope))
