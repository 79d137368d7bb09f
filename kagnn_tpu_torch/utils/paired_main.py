"""Every kernel at the main paths' shapes on the card: a digest of its
outputs' bits and its ms per call, one JSON line a kernel and dtype, so
that two trees can be held to the same bits and compared in time within
one call (parent, change, change, parent):

    python -m kagnn_tpu_torch.utils.paired_main [label]

Another tree (a parent's `git archive`) is measured by copying this file
into its `kagnn_tpu_torch/utils/` and running the same command from its
root (run as a file, the script's own directory would come first on the
path, and `utils/logging.py` would stand in for the standard library's).

On the arxiv-sized graph (169,343 nodes, 1,166,243 edges, seed 0), inputs
from a fixed seed, bf16 and f32: spmm over the receiver CSR (idx =
senders) at D 64 and 128 and over the sender CSR (Aᵀdz) at D 64, the
B-spline forward and backward at (64, 64) and (128, 64), gin_fused at D 64
and 128, gcn_agg at D 64, the FastKAN forward and backward at (64, 64),
gin_fastkan at D 64, the RBF product (8 centers, x f32 or bf16, w bf16) at
(64, 64), the three GAT kernels at 4 heads of 64, and the narrow sum at k
4. The digest is SHA-256 over each output's bytes; ms from CUDA events
(`profiling.time_ms`). No check here: chip_smoke.py holds the kernels to
their plain versions; equal digests between two trees mean equal bits.
"""
from __future__ import annotations

import hashlib
import json
import sys

import torch


def _digest(out) -> str:
    outs = out if isinstance(out, (tuple, list)) else (out,)
    h = hashlib.sha256()
    for t in outs:
        if t is not None:
            h.update(t.detach().contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def cases(g, dt, gen):
    """(name, fn) of each kernel call at the main shapes in dtype dt."""
    from kagnn_tpu_torch.kan.bspline import make_grid
    from kagnn_tpu_torch.kernels import bspline_fused as bf
    from kagnn_tpu_torch.kernels import fastkan_layer as fk
    from kagnn_tpu_torch.kernels import gat_bwd as gbw
    from kagnn_tpu_torch.kernels import gat_fused as gfu
    from kagnn_tpu_torch.kernels import gcn_agg as ga
    from kagnn_tpu_torch.kernels import gin_fastkan as gfk
    from kagnn_tpu_torch.kernels import gin_fused as gf
    from kagnn_tpu_torch.kernels import rbf_fused as rf
    from kagnn_tpu_torch.kernels import spmm

    N = g.n_node_pad

    def rnd(*shape, scale=1.0, dtype=dt):
        return (torch.randn(*shape, generator=gen, device="cuda") * scale).to(dtype)

    out = []
    for D in (64, 128):
        x = rnd(N, D)
        out.append((f"spmm recv D={D}", lambda x=x: spmm.sorted_segment_sum(
            x, g.recv_row_ptr, g.senders)))
    dz = rnd(N, 64)
    out.append(("spmm Aᵀdz D=64", lambda: spmm.sorted_segment_sum(
        dz, g.send_row_ptr, g.receivers_by_sender)))
    for D, O in ((64, 64), (128, 64)):
        knots = make_grid(D, 4, 3, device="cuda").t().contiguous().to(dt)
        fa = (rnd(N, D), knots, rnd(D, O, scale=0.3), rnd(7 * D, O, scale=0.3), 3)
        dout = rnd(N, O, scale=0.1)
        out.append((f"bspline_fwd ({D},{O})", lambda fa=fa: bf.kan_linear_fwd(*fa)))
        out.append((f"bspline_bwd ({D},{O})",
                    lambda fa=fa, dout=dout: bf.kan_linear_bwd(*fa[:4], dout, 3)))
        gargs = (fa[0], g.senders, g.recv_row_ptr, *fa[1:], 0.0)
        out.append((f"gin_fused D={D}", lambda a=gargs: gf.gin_kan_fwd(*a)))
    hs = rnd(N, 64)
    dinv = torch.rand(N, generator=gen, device="cuda") + 0.5
    out.append(("gcn_agg D=64", lambda: ga.gcn_agg_fwd(hs, dinv, g.senders, g.recv_row_ptr,
                                                        g.receivers)))
    x = rnd(N, 64)
    lw = (1.0 + rnd(64, scale=0.2), rnd(64, scale=0.1), rnd(4 * 64, 64, scale=0.3),
          rnd(64, 64, scale=0.3), rnd(64, scale=0.1))
    dout = rnd(N, 64, scale=0.1)
    out.append(("fastkan_fwd (64,64)", lambda: fk.fastkan_layer_fwd(x, *lw, -2.0, 2.0)))
    out.append(("fastkan_bwd (64,64)", lambda: fk.fastkan_layer_bwd(x, *lw[:4], dout,
                                                                     -2.0, 2.0)))
    out.append(("gin_fastkan D=64", lambda: gfk.gin_fastkan_fwd(
        x, g.senders, g.recv_row_ptr, *lw, 0.0, -2.0, 2.0)))
    w8 = rnd(8 * 64, 64, scale=0.3, dtype=torch.bfloat16)
    out.append(("rbf_fwd G=8 (64,64)", lambda: rf.rbf_spline_fwd(x, w8, -2.0, 2.0)))
    out.append(("rbf_bwd G=8 (64,64)", lambda: rf.rbf_spline_bwd(x, w8, dout, -2.0, 2.0)))
    h = rnd(N, 256)
    asrc, adst = (rnd(N, 4, scale=2.0, dtype=torch.float32) for _ in range(2))
    fa = (h, asrc, adst, g.senders, g.recv_row_ptr, g.n_edge, 0.2)
    o, alpha = gfu.gat_fwd(*fa)
    dh = rnd(N, 256, scale=0.1)
    S = (dh * o).float().reshape(N, 4, 64).sum(2).contiguous()
    out.append(("gat_fwd H=4 C=64", lambda: gfu.gat_fwd(*fa)))
    out.append(("gat_dadst H=4 C=64", lambda: gbw.gat_dadst(
        h, asrc, adst, alpha, S, dh, g.senders, g.recv_row_ptr, g.n_edge, 0.2)))
    out.append(("gat_sender H=4 C=64", lambda: gbw.gat_sender(
        h, asrc, adst, alpha, S, dh, g.receivers_by_sender, g.send_row_ptr, g.n_edge, 0.2)))
    vals = rnd(g.n_edge_pad, 4)
    out.append(("spmm_narrow k=4", lambda: spmm.sorted_segment_sum_narrow(
        vals, g.receivers, N)))
    return out


def main(label: str = "") -> list:
    from kagnn_tpu_torch.data import arxiv_scale_graph
    from kagnn_tpu_torch.graphs import single_graph
    from kagnn_tpu_torch.utils.profiling import time_ms

    d = arxiv_scale_graph()
    g = single_graph(d["senders"], d["receivers"], nodes=d["nodes"], y=d["y"],
                     edge_pad_multiple=1024, device="cuda")
    rows = []
    for dt in (torch.bfloat16, torch.float32):
        gen = torch.Generator(device="cuda").manual_seed(0)
        for name, fn in cases(g, dt, gen):
            row = {"label": label, "kernel": name, "dtype": str(dt).split(".")[1],
                   "digest": _digest(fn()), "ms": round(time_ms(fn), 4)}
            rows.append(row)
            print(json.dumps(row), flush=True)
    return rows


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "")
