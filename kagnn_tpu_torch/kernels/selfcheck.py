"""On-card checks shared by `chip_smoke.py` and `tests/test_torch_cuda.py`:
the autograd Functions of the FastKAN, GCN, GAT and RBF kernels, the bar of
a bf16 weight gradient summed over row tiles (`dw_walk_check`), the
graphs of the split gcn_agg (`gcn_split_graph`) and the GAT kernels' split
of heavy receiver rows (`gat_split_case`, `check_gat_split`)."""
from __future__ import annotations

import torch

import numpy as np

from kagnn_tpu_torch.graphs import single_graph
from kagnn_tpu_torch.kernels import bspline_fused as bf
from kagnn_tpu_torch.kernels import fastkan_layer as fk
from kagnn_tpu_torch.kernels import gat_bwd as gbw
from kagnn_tpu_torch.kernels import gat_fused as gfu
from kagnn_tpu_torch.kernels import gcn_agg as ga
from kagnn_tpu_torch.kernels import gin_fastkan as gfk
from kagnn_tpu_torch.kernels import rbf_fused as rf
from kagnn_tpu_torch.kernels import spmm
from kagnn_tpu_torch.kernels._common import (GAT_PIECE, dw_tile, round_to,
                                             tile_partials)

BF16_ULP = 2.0 ** -8  # relative spacing of bf16 values
# A bf16 weight gradient that a kernel walks over row tiles (the RBF,
# B-spline and FastKAN backwards) is held to the kernels' elementwise bar,
# 4 ulps of max(|plain|, mean |plain|) (the `close` of the callers), up to
# DW_CLOSE_TILES tiles: one tile is one rounding of one partial, as before
# the walk. Past it an element whose running sum cancels ends far below
# the values it passed through, and a flipped rounding on the way is an
# ulp of those: at 6 tiles (700 rows, (128, 256)) the B-spline dW read
# 1.307 of the 4-ulp bar (PERF.md §6). There the walk bar holds:
# elementwise DW_WALK_ULPS units of 2^-8 of the largest |value| the
# element's running sum took (floored at the mean of those peaks over the
# gradient: a partial that cancels to near zero differs between two f32
# summation orders by far more than its own ulp: without the floor the
# sound FastKAN dW at (256, 256) reads 1.013), and at most DW_WALK_SHARE
# of the elements (or 2, for gradients of fewer than 200) differing from
# the plain walk at all. Set from readings at DW_WALK_TILES = 331 tiles
# (PERF.md §6): the RBF kernel against its plain version, and reduces that
# round once at the end or skip the rounding of each partial, which the bar
# must refuse. Over more tiles the units grow with the square root of the
# tile count: each tile's partial can flip its rounding on its own, and the
# walks' differences add up as a random walk (16 units at the B-spline's
# 1,323 tiles, where one element of 65,536 read 8.7 units at (128, 256);
# PERF.md §6).
DW_CLOSE_TILES = 1
DW_WALK_ULPS = 8
DW_WALK_TILES = 331
DW_WALK_SHARE = 0.01


def dw_walk_check(name: str, a: torch.Tensor, b: torch.Tensor, tile: int,
                  got: torch.Tensor, want: torch.Tensor,
                  wrong_must_fail: bool = False, log=print) -> float:
    """The bf16 gradient `got` that a kernel summed as sum over row tiles of
    a[tile]^T @ b[tile], against its plain version `want`. Both add the
    tiles' f32 partials in tile order, rounding each partial and the running
    sum to bf16; a partial whose summation order flips its rounding moves
    the rest of that element's walk by about an ulp of the running sum, so
    few elements differ, each by a few ulps of its peak (the bar above). The
    readings without the mean floor (each element's own peak as its scale)
    and against the kernels' 4-ulp bar are logged beside it. With
    `wrong_must_fail` (many tiles) two wrong reduces
    of the same partials are read too and each must fail the bar: the sum in
    f32 rounded once, and the running sum without rounding each partial.
    Raises AssertionError; returns max |got - want|."""
    bf = torch.bfloat16
    shape = (a.shape[1], b.shape[1])
    walk, peak, once, raw = (torch.zeros(shape, device=a.device) for _ in range(4))
    for p in tile_partials(a, b, tile):
        walk = round_to(walk + round_to(p, bf), bf)
        peak = torch.maximum(peak, walk.abs())
        once += p
        raw = round_to(raw + p, bf)
    want = want.float().reshape(shape)
    tiles = -(-a.shape[0] // tile)
    units = DW_WALK_ULPS * max(1.0, (tiles / DW_WALK_TILES) ** 0.5)
    tol = units * BF16_ULP * peak.clamp(min=max(peak.mean().item(), 1e-30))
    bare = units * BF16_ULP * peak.clamp(min=1e-30)
    four = 4 * BF16_ULP * want.abs().clamp(min=max(want.abs().mean().item(), 1e-30))
    limit = max(DW_WALK_SHARE, 2.0 / walk.numel())

    def reading(v):
        diff = (v.float().reshape(shape) - want).abs()
        return ((diff / tol).max().item(), (diff / bare).max().item(),
                (diff / four).max().item(), (diff > 0).float().mean().item(),
                diff.max().item())

    ratio, ratio_bare, ratio_four, share, err = reading(got)
    ok = ratio <= 1.0 and share <= limit and err == err
    log(f"  {name}: max_abs_err={err:.3e} worst err/tol={ratio:.3f} (tol "
        f"{units:.1f} bf16 ulps of the running-sum peak; without the mean "
        f"floor {ratio_bare:.3f}; of the 4-ulp bar {ratio_four:.3f}), "
        f"{share:.5f} of elements differ (limit {limit:.5f}; {tiles} tiles) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with its plain "
                             f"version: err/tol {ratio}, share {share}")
    if wrong_must_fail:
        for wname, v in (("round-once", round_to(once, bf)),
                         ("unrounded-partials", raw)):
            wr, wb, _, ws, _ = reading(v)
            refused = wr > 1.0 or ws > limit
            log(f"    {wname} reduce: worst err/tol={wr:.3f} (without the "
                f"mean floor {wb:.3f}), {ws:.5f} of elements differ: "
                f"{'refused' if refused else 'FAIL: passes'}")
            if not refused:
                raise AssertionError(f"{name}: the bar does not refuse a "
                                     f"{wname} reduce")
    return err


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


def check_bspline_bwd(name, x, knots, wb, ws, dout, k, close,
                      wrong_must_fail=False, log=print) -> float:
    """kan_linear_bwd against its plain version on the card: dx with
    close(name, got, want) -> error, and [dWb; dWs] with `close` in f32 or
    up to DW_CLOSE_TILES tiles, else `dw_walk_check` (its 128-row tiles).
    Returns the worst error."""
    got = bf.kan_linear_bwd(x, knots, wb, ws, dout, k)
    want = bf.kan_linear_bwd_plain(x, knots, wb, ws, dout, k)
    err = close(f"{name} dx", got[0], want[0])
    dw, pdw = torch.cat(got[1:]), torch.cat(want[1:])
    if x.dtype != torch.bfloat16 or -(-x.shape[0] // bf.JAX_TILE) <= DW_CLOSE_TILES:
        return max(err, close(f"{name} dW", dw, pdw))
    return max(err, dw_walk_check(f"{name} dW", bf.dw_operand(x, knots, k), dout,
                                  bf.JAX_TILE, dw, pdw, wrong_must_fail, log))


def check_fastkan_bwd(name, x, lng, lnb, w, wb, dout, close,
                      wrong_must_fail=False, log=print) -> float:
    """fastkan_layer_bwd against its plain version on the card: dx with
    close(name, got, want) -> error, and dlng, dlnb, dW, dWb, dbb with
    `close` in f32 or up to DW_CLOSE_TILES tiles, else `dw_walk_check` (its
    `dw_tile` rows). Returns the worst error."""
    args = (x, lng, lnb, w, wb, dout, -2.0, 2.0)
    got, want = fk.fastkan_layer_bwd(*args), fk.fastkan_layer_bwd_plain(*args)
    if not all(torch.isfinite(t).all() for t in got):
        raise AssertionError(f"{name}: non-finite gradient")
    err = close(f"{name} dx", got[0], want[0])
    tile = dw_tile(x.shape[0])
    if x.dtype != torch.bfloat16 or -(-x.shape[0] // tile) <= DW_CLOSE_TILES:
        return max([err] + [close(f"{name} {n}", a, b) for n, a, b in zip(
            ("dlng", "dlnb", "dw", "dwb", "dbb"), got[1:], want[1:])])
    _, terms = fk.fastkan_bwd_terms(x, lng, lnb, w, dout, -2.0, 2.0)
    return max([err] + [dw_walk_check(f"{name} {n}", a, b, tile, g, p, wrong_must_fail, log)
                        for n, (a, b), g, p in zip(("dlng", "dlnb", "dw", "dwb", "dbb"),
                                                   terms, got[1:], want[1:])])


def gcn_split_graph(kind: str, device="cuda"):
    """A graph for the row split of gcn_agg: "hub", 2,000 nodes with 20,000
    random edges and node 0 receiving 100,000 more (1,563 pieces of 64);
    "light", 3,000 nodes with 60,000 random edges, every row of 64 in-edges
    or fewer (no row is split)."""
    n, e, hub = {"hub": (2000, 20000, 100_000), "light": (3000, 60000, 0)}[kind]
    rng = np.random.default_rng(8)
    snd, rcv = rng.integers(0, n, e), rng.integers(1, n, e)
    if hub:
        snd = np.concatenate([snd, rng.integers(0, n, hub)])
        rcv = np.concatenate([rcv, np.zeros(hub, np.int64)])
    g = single_graph(snd, rcv, n_node=n, device=device)
    top = int((g.recv_row_ptr[1:] - g.recv_row_ptr[:-1]).max())
    if (top < hub) if hub else top > ga.PIECE:
        raise AssertionError(f"gcn_split_graph({kind}): largest in-degree {top}")
    return g


# (receiver, valid in-edges) of gat_split_case's rows around the GAT
# kernels' piece: the main graph's hub in-degree at node 0 (43 pieces), and
# past the light rows one short of a piece, a piece, one past it, and a
# heavy row of 300 that starts inside the chunk where the 65-edge row ends
# (two heavy rows in one chunk, both starting mid-chunk)
GAT_SPLIT_ROWS = ((0, 2748), (300, GAT_PIECE - 1), (301, GAT_PIECE),
                  (302, GAT_PIECE + 1), (303, 300))
GAT_SPLIT_CASES = ("all", "heavy", "light")


def gat_split_case(kind: str, device="cuda"):
    """(graph, n_edge) for the GAT kernels' split: the rows of
    GAT_SPLIT_ROWS, 2,000 edges over the light rows 1-299 between them,
    isolated nodes, and padding to a multiple of 1,024 edges (the pad row
    holds it); "all" takes every valid edge, "heavy" and "light" cut n_edge
    inside the 300-edge row, the last in the receiver order, leaving it 200
    edges (still heavy, its range running past n_edge) or 40 (light by its
    valid edges). The light rows stay valid in every case: they set the
    mean that floors the bar of `close` (dadst sums cancel: node 0's is
    about 1e-6 of the sum of its terms' magnitudes)."""
    rng = np.random.default_rng(21)
    rcv = np.concatenate([np.full(GAT_SPLIT_ROWS[0][1], 0), rng.integers(1, 300, 2000)]
                         + [np.full(d, r) for r, d in GAT_SPLIT_ROWS[1:]])
    n = 320
    g = single_graph(rng.integers(0, n, rcv.size), rcv, n_node=n,
                     edge_pad_multiple=1024, device=device)
    start = int(g.recv_row_ptr[GAT_SPLIT_ROWS[-1][0]])
    return g, {"all": g.n_edge, "heavy": start + 200, "light": start + 40}[kind]


def check_gat_split(kind: str, heads: int, c: int, dtype, close, gen):
    """gat_fwd (out, alpha) and gat_dadst against their plain versions on
    gat_split_case(kind) at H heads of C columns, logits of a few tens;
    each kernel called twice and equal bit for bit (no atomics). close(name,
    got, want, kind) holds a pair to the kernels' bar ("f32" for alpha and
    dadst, else the dtype's). Returns the largest error of each kernel."""
    g, n_edge = gat_split_case(kind)
    n, hc = g.n_node_pad, heads * c

    def rand(shape, dt, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * scale).to(dt)

    h, dout = rand((n, hc), dtype), rand((n, hc), dtype)
    asrc, adst = rand((n, heads), torch.float32, 10.0), rand((n, heads), torch.float32, 10.0)
    fa = (h, asrc, adst, g.senders, g.recv_row_ptr, n_edge, 0.2)
    out, alpha = gfu.gat_fwd(*fa)
    want = gfu.gat_fwd_plain(*fa)
    tag = f"{kind} H={heads} C={c}"
    err = max(close(f"gat_fwd split {tag} out", out, want[0], None),
              close(f"gat_fwd split {tag} alpha", alpha, want[1], "f32"))
    again = gfu.gat_fwd(*fa)
    if not (torch.equal(out, again[0]) and torch.equal(alpha, again[1])):
        raise AssertionError(f"gat_fwd split {tag}: two calls differ")
    s = (dout * out).float().reshape(n, heads, c).sum(2).contiguous()
    da = (h, asrc, adst, alpha, s, dout, g.senders, g.recv_row_ptr, n_edge, 0.2)
    got = gbw.gat_dadst(*da)
    err_dadst = close(f"gat_dadst split {tag}", got, gbw.gat_dadst_plain(*da), "f32")
    if not torch.equal(got, gbw.gat_dadst(*da)):
        raise AssertionError(f"gat_dadst split {tag}: two calls differ")
    return err, err_dadst
