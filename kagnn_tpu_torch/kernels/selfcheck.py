"""On-card checks of the autograd Functions of the FastKAN, GCN, GAT and RBF
kernels, shared by `chip_smoke.py` and `tests/test_torch_cuda.py`."""
from __future__ import annotations

import torch

from kagnn_tpu_torch.kernels import fastkan_layer as fk
from kagnn_tpu_torch.kernels import gat_bwd as gbw
from kagnn_tpu_torch.kernels import gat_fused as gfu
from kagnn_tpu_torch.kernels import gcn_agg as ga
from kagnn_tpu_torch.kernels import gin_fastkan as gfk
from kagnn_tpu_torch.kernels import rbf_fused as rf
from kagnn_tpu_torch.kernels import spmm


def fastkan_gcn_chain(g, d: int = 16, o: int = 8, num_grids: int = 4) -> float:
    """FastKANLayerFn -> GcnAggregate -> GinFastKan chained over the CUDA
    GraphBatch `g`, in f32 with TF32 off (the flag is restored after):
    the values and every gradient through the kernels against the same
    chain through the plain versions on the CPU (rtol 1e-3 / atol 1e-5, the
    gradients' bar); then no segment sum in the GIN backward when its input
    needs no gradient. Raises AssertionError on a disagreement and returns
    the worst max-abs error."""
    gen = torch.Generator().manual_seed(2)
    G = num_grids

    def weights(fin, fout):
        return [torch.randn(s, generator=gen) * 0.3
                for s in ((fin,), (fin,), (fout, fin * G), (fout, fin), (fout,))]

    w1, w2 = weights(d, o), weights(o, o)
    x = torch.randn(g.n_node_pad, d, generator=gen)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        res = {}
        for dev, graph in (("cuda", g), ("cpu", g.to("cpu"))):
            xs = x.to(dev, copy=True).requires_grad_(True)
            wt = [w.to(dev, copy=True).requires_grad_(True) for w in w1 + w2]
            dinv = torch.rsqrt(graph.in_degrees.float() + 1.0)
            h = fk.fastkan_layer_fused(xs, *wt[:5], -2.0, 2.0, G)
            h = ga.gcn_aggregate_fused(h * dinv[:, None], graph, dinv)
            out = gfk.gin_fastkan_fused(h, graph, 0.1, *wt[5:], -2.0, 2.0, G)
            out[graph.node_mask].sum().backward()
            res[dev] = [out.detach()[graph.node_mask], xs.grad] + [w.grad for w in wt]
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    worst = 0.0
    for a, b in zip(res["cuda"], res["cpu"]):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-3, atol=1e-5)
        worst = max(worst, (a.cpu() - b).abs().max().item())
    before = spmm.sorted_segment_sum.launches
    wt = [w.to("cuda", copy=True).requires_grad_(True) for w in w2]
    gfk.gin_fastkan_fused(torch.randn(g.n_node_pad, o, device="cuda"), g, 0.0,
                          *wt, -2.0, 2.0, G).sum().backward()
    torch.cuda.synchronize()
    if spmm.sorted_segment_sum.launches != before:
        raise AssertionError("GinFastKan ran A^T dz for an input that needs "
                             "no gradient")
    if not all(w.grad is not None for w in wt):
        raise AssertionError("GinFastKan left a weight without a gradient")
    return worst


def gat_attention_chain(g, heads: int = 2, c: int = 16) -> float:
    """GatAttention twice in a row over the CUDA GraphBatch `g`, each with
    its logits from h through a block-diagonal matrix as GATConv forms
    them, in f32 with TF32 off (restored after): the values and the
    gradients of h and of both attention vectors through the kernels
    against the same chain through the plain versions on the CPU (rtol 1e-3
    / atol 1e-5, the gradients' bar); each of the three kernels launched
    once per layer. Raises AssertionError on a disagreement and returns the
    worst max-abs error."""
    gen = torch.Generator().manual_seed(3)
    hc = heads * c
    h0 = torch.randn(g.n_node_pad, hc, generator=gen)
    atts = [torch.randn(1, heads, c, generator=gen) * 0.3 for _ in range(4)]
    eye = torch.eye(heads)
    fns = (gfu.gat_fwd, gbw.gat_dadst, gbw.gat_sender)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        res = {}
        for dev, graph in (("cuda", g), ("cpu", g.to("cpu"))):
            before = [f.launches for f in fns]
            x = h0.to(dev, copy=True).requires_grad_(True)
            att = [a.to(dev, copy=True).requires_grad_(True) for a in atts]
            h = x
            for layer in range(2):
                src, dst = (
                    (a[0][:, :, None] * eye.to(dev)[:, None, :]).reshape(hc, heads)
                    for a in att[2 * layer:2 * layer + 2])
                h = gfu.gat_attention_fused(h, h @ src, h @ dst, graph, 0.2,
                                            att_src_matrix=src)
                h = torch.tanh(h)
            h[graph.node_mask].sum().backward()
            if dev == "cuda":
                torch.cuda.synchronize()
                if [f.launches - b for f, b in zip(fns, before)] != [2, 2, 2]:
                    raise AssertionError("GatAttention did not launch each "
                                         "GAT kernel once per layer")
            res[dev] = [h.detach()[graph.node_mask], x.grad] + [a.grad for a in att]
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    worst = 0.0
    for a, b in zip(res["cuda"], res["cpu"]):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-3, atol=1e-5)
        worst = max(worst, (a.cpu() - b).abs().max().item())
    return worst


def rbf_chain(n: int = 700, d: int = 16, o: int = 8, num_grids: int = 8) -> float:
    """RbfSplineMatmul twice in a row, tanh between, as a layernorm-free and
    base-free FastKAN of two layers, in f32 with TF32 off (restored after):
    the values and the gradients of x and both spline weights through the
    kernels against the same chain through the plain versions on the CPU
    (rtol 1e-3 / atol 1e-5, the gradients' bar); each RBF kernel launched
    once per layer. Raises AssertionError on a disagreement and returns the
    worst max-abs error."""
    gen = torch.Generator().manual_seed(4)
    G = num_grids
    x0 = torch.randn(n, d, generator=gen) * 1.5
    ws = [torch.randn(fout, fin * G, generator=gen) * 0.3
          for fin, fout in ((d, o), (o, o))]
    fns = (rf.rbf_spline_fwd, rf.rbf_spline_bwd)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        res = {}
        for dev in ("cuda", "cpu"):
            before = [f.launches for f in fns]
            x = x0.to(dev, copy=True).requires_grad_(True)
            w = [t.to(dev, copy=True).requires_grad_(True) for t in ws]
            h = torch.tanh(rf.fastkan_fused(x, w[0], -2.0, 2.0, G))
            out = rf.fastkan_fused(h, w[1], -2.0, 2.0, G)
            (out * torch.cos(out)).sum().backward()
            if dev == "cuda":
                torch.cuda.synchronize()
                if [f.launches - b for f, b in zip(fns, before)] != [2, 2]:
                    raise AssertionError("RbfSplineMatmul did not launch each "
                                         "RBF kernel once per layer")
            res[dev] = [out.detach(), x.grad] + [t.grad for t in w]
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    worst = 0.0
    for a, b in zip(res["cuda"], res["cpu"]):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-3, atol=1e-5)
        worst = max(worst, (a.cpu() - b).abs().max().item())
    return worst
