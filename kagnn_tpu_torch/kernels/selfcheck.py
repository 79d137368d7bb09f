"""On-card checks shared by `chip_smoke.py` and `tests/test_torch_cuda.py`:
the autograd Functions of the FastKAN, GCN, GAT and RBF kernels, the bar of
a bf16 weight gradient summed over row tiles (`dw_walk_check`), the
graphs of the split gcn_agg (`gcn_split_graph`), the GAT kernels' split
of heavy receiver rows (`gat_split_case`, `check_gat_split`) and of heavy
sender rows (`gat_sender_split_case`, `check_gat_sender_split`), spmm's
split of heavy rows of either CSR (`spmm_split_graph`, `check_spmm_split`;
the f64 references of the spmm and gcn_agg checks on heavy rows,
`spmm_f64`, `gcn_agg_f64`),
gin_fused's and gin_fastkan's split of heavy receiver rows on the same graph
(`check_gin_split`, `check_gin_fastkan_split`; the GIN aggregate summed in
f64, `gin_z_f64`), the f64 references of the GAT kernels on heavy rows
(`gat_fwd_f64`, `gat_dadst_f64`, `gat_sender_f64`) and the kernels the RBF
forward and backward and the GIN kernels launch by dtype (`rbf_fwd_expected`,
`rbf_bwd_kernels`, `gin_fused_expected`, `gin_fastkan_expected`), and the
narrow segment sum's receivers, row pointer and split (`narrow_cases`,
`check_narrow`, its f64 reference `narrow_f64`), and the graph tasks' segment
sums on a padded batch whose pad row and pad graph are heavy
(`graph_sum_batch`, `check_graph_sums`) and their prefetched batches
(`check_prefetch`), and the bars of a bf16 model's gradients against a
reference model's (`bf16_grad_ratios`), and the protocol layer's: the
card's least-squares solve against the CPU's (`check_lstsq`), the B-spline
kernels on adapted knots (`adapted_knots`, `check_adapted_layer`),
including knots whose narrowest span bf16 rounds to zero
(`degenerate_knots`, `close_nonfinite`), and the two halo entries of the
fused GIN kernels on one shard of a halo plan, with no process group
(`halo_entry_graph`, `halo_shard`, `check_halo_entry`), and the fused
masked BatchNorm against the module's plain version and its f64 function
(`masked_bn_case`, `masked_bn_f64`, `check_masked_bn`)."""
from __future__ import annotations

import torch

import numpy as np

from kagnn_tpu_torch.graphs import single_graph
from kagnn_tpu_torch.kan.bspline import make_grid
from kagnn_tpu_torch.kernels import bspline_fused as bf
from kagnn_tpu_torch.kernels import fastkan_layer as fk
from kagnn_tpu_torch.kernels import gat_bwd as gbw
from kagnn_tpu_torch.kernels import gat_fused as gfu
from kagnn_tpu_torch.kernels import gcn_agg as ga
from kagnn_tpu_torch.kernels import gin_fastkan as gfk
from kagnn_tpu_torch.kernels import gin_fused as gf
from kagnn_tpu_torch.kernels import masked_bn as mbn
from kagnn_tpu_torch.kernels import rbf_fused as rf
from kagnn_tpu_torch.kernels import spmm
from kagnn_tpu_torch.kernels._common import (GAT_PIECE, dleaky, dw_tile,
                                             gat_edges, leaky, round_to,
                                             segment_ids, tile_partials)
from kagnn_tpu_torch.ops.norm import MaskedBatchNorm

BF16_ULP = 2.0 ** -8  # relative spacing of bf16 values
# A bf16 model's gradient, in bf16 ulps of the gradient's scale: the bar
# against the reference's bf16 gradient, and the most of the reference's
# own distance from its f32 gradient that may be added to that bar (the
# JAX bf16 graph models' gradients on 8 molecules read up to 14 ulps from
# their f32 ones where the port's differ from them by more than 8 ulps,
# tests/test_torch_graph_steps.py)
BF16_GRAD_ULPS = 8
BF16_GRAD_NOISE_CAP = 14


def bf16_grad_ratios(got, ref, exact, scale: float) -> tuple[float, float]:
    """A bf16 model's gradient `got` against the reference model's bf16
    gradient `ref` and its f32 gradient `exact` (numpy arrays), at `scale`;
    the ratios of two distances to their bars, each passing at <= 1:

      * |got - ref| <= BF16_GRAD_ULPS ulps + min(|ref - exact|,
        BF16_GRAD_NOISE_CAP ulps): the reference's bf16 rounding, where it
        is noisy, widens the bar by at most the cap;
      * |got - exact| <= |ref - exact| + BF16_GRAD_ULPS ulps: `got` is no
        farther from the f32 gradient than the reference's bf16 gradient
        is, within BF16_GRAD_ULPS ulps.

    Each distance is the largest over the gradient's elements."""
    u = BF16_ULP * scale
    noise = float(np.abs(ref - exact).max())
    bars = (BF16_GRAD_ULPS * u + min(noise, BF16_GRAD_NOISE_CAP * u),
            noise + BF16_GRAD_ULPS * u)
    errs = (float(np.abs(got - ref).max()), float(np.abs(got - exact).max()))
    return tuple(e / t if t > 0 else (0.0 if e == 0 else float("inf"))
                 for e, t in zip(errs, bars))
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
    close(name, got, want) -> error, and [dWb; dWs] with `close` in f32
    weights or up to DW_CLOSE_TILES tiles, else `dw_walk_check` (its 128-row
    tiles; bf16 weights beside an f32 x walk too). Returns the worst
    error."""
    got = bf.kan_linear_bwd(x, knots, wb, ws, dout, k)
    want = bf.kan_linear_bwd_plain(x, knots, wb, ws, dout, k)
    err = close(f"{name} dx", got[0], want[0])
    dw, pdw = torch.cat(got[1:]), torch.cat(want[1:])
    if wb.dtype != torch.bfloat16 or -(-x.shape[0] // bf.JAX_TILE) <= DW_CLOSE_TILES:
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
    if w.dtype != torch.bfloat16 or -(-x.shape[0] // tile) <= DW_CLOSE_TILES:
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


def gat_fwd_f64(h, asrc, adst, senders, recv_row_ptr, n_edge: int, slope: float):
    """gat_fwd_plain's function with its sums in f64, rounded once: (out in
    h's dtype, alpha f32). Each edge's terms are the plain version's f32
    values (logits, shifted exponentials, the weight rounded to h's dtype,
    its products with h); only the row sums, the division and the log run in
    f64."""
    n, hc = h.shape
    heads = asrc.shape[1]
    c = hc // heads
    rcv, snd = gat_edges(recv_row_ptr, senders, n_edge)
    a_s, a_d = asrc.float(), adst.float()
    sl, lg = leaky(a_s + a_d, slope), leaky(a_s[snd] + a_d[rcv], slope)
    mx = sl.scatter_reduce(0, rcv[:, None].expand(-1, heads), lg, "amax")
    mx = mx.to(torch.bfloat16).float()
    es, w = torch.exp(sl - mx), torch.exp(lg - mx[rcv])
    d = torch.float64
    den = es.to(d).index_add(0, rcv, w.to(d))
    wq = w.to(h.dtype).float()
    acc = (es.repeat_interleave(c, 1) * h.float()).to(d)
    acc.index_add_(0, rcv, (wq.repeat_interleave(c, 1) * h[snd].float()).to(d))
    out = (acc / den.repeat_interleave(c, 1)).to(h.dtype)
    return out, (mx.to(d) + torch.log(den)).float()


def gat_dadst_f64(h, asrc, adst, alpha, s, dout, senders, recv_row_ptr, n_edge: int,
                  slope: float):
    """gat_dadst_plain's function with its sums in f64, rounded once to f32:
    each edge's term is the plain version's f32 value."""
    rcv, snd = gat_edges(recv_row_ptr, senders, n_edge)
    _, dz = gbw._edge_terms(h, asrc, adst, alpha, s, dout, snd, rcv, slope)
    out = torch.zeros(alpha.shape, dtype=torch.float64, device=h.device)
    return out.index_add_(0, rcv, dz.double()).float()


def check_gat_split(kind: str, heads: int, c: int, dtype, close, gen):
    """gat_fwd (out, alpha) and gat_dadst on gat_split_case(kind) at H heads
    of C columns, logits of a few tens, against their plain functions
    summed in f64 (`gat_fwd_f64`, `gat_dadst_f64`: the plain versions' f32
    `index_add_` adds node 0's 2,748 terms in its atomics' order, new each
    run); each kernel called twice and equal bit for bit (no atomics).
    close(name, got, want, kind) holds a pair to the kernels' bar ("f32" for
    alpha and dadst, else the dtype's). Returns the largest error of each
    kernel."""
    g, n_edge = gat_split_case(kind)
    n, hc = g.n_node_pad, heads * c

    def rand(shape, dt, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * scale).to(dt)

    h, dout = rand((n, hc), dtype), rand((n, hc), dtype)
    asrc, adst = rand((n, heads), torch.float32, 10.0), rand((n, heads), torch.float32, 10.0)
    fa = (h, asrc, adst, g.senders, g.recv_row_ptr, n_edge, 0.2)
    out, alpha = gfu.gat_fwd(*fa)
    want = gat_fwd_f64(*fa)
    tag = f"{kind} H={heads} C={c}"
    err = max(close(f"gat_fwd split {tag} out", out, want[0], None),
              close(f"gat_fwd split {tag} alpha", alpha, want[1], "f32"))
    again = gfu.gat_fwd(*fa)
    if not (torch.equal(out, again[0]) and torch.equal(alpha, again[1])):
        raise AssertionError(f"gat_fwd split {tag}: two calls differ")
    s = (dout * out).float().reshape(n, heads, c).sum(2).contiguous()
    da = (h, asrc, adst, alpha, s, dout, g.senders, g.recv_row_ptr, n_edge, 0.2)
    got = gbw.gat_dadst(*da)
    err_dadst = close(f"gat_dadst split {tag}", got, gat_dadst_f64(*da), "f32")
    if not torch.equal(got, gbw.gat_dadst(*da)):
        raise AssertionError(f"gat_dadst split {tag}: two calls differ")
    return err, err_dadst


def gat_sender_split_case(kind: str, device="cuda"):
    """(graph, n_edge) for gat_sender's split of heavy sender rows:
    gat_split_case's edges reversed, so that node 0 sends 2,748 valid edges
    and nodes 300-303 send 63, 64, 65 and 300 (two heavy rows starting inside
    one chunk of the sender order), with the same light rows, isolated
    nodes and 1,024-edge padding; "heavy" and "light" cut n_edge inside
    node 303's out-edges, the last of the sender order, leaving it 200
    (still heavy, its range running past n_edge) or 40 (light by its valid
    edges)."""
    g, _ = gat_split_case("all", device="cpu")
    valid = slice(0, g.n_edge)
    rcv = torch.repeat_interleave(
        torch.arange(g.n_node_pad), torch.diff(g.recv_row_ptr).long())[valid]
    rg = single_graph(rcv.numpy(), g.senders[valid].long().numpy(), n_node=g.n_node,
                      edge_pad_multiple=1024, device=device)
    row = GAT_SPLIT_ROWS[-1][0]
    start = int(rg.send_row_ptr[row])
    if int(rg.send_row_ptr[row + 1]) != rg.n_edge:
        raise AssertionError("gat_sender_split_case: node 303 is not the last sender")
    return rg, {"all": rg.n_edge, "heavy": start + 200, "light": start + 40}[kind]


def gat_sender_f64(h, asrc, adst, alpha, s, dout, receivers_by_sender, send_row_ptr,
                   n_edge: int, slope: float):
    """gat_sender_plain's function with every product and sum in f64, rounded
    once to f32: (dh, dasrc)."""
    snd, rcv = gat_edges(send_row_ptr, receivers_by_sender, n_edge)
    heads, d = asrc.shape[1], torch.float64
    c = h.shape[1] // heads
    z = asrc.to(d)[snd] + adst.to(d)[rcv]
    w = torch.exp(torch.clamp_max(leaky(z, slope) - alpha.to(d)[rcv], gbw.CLAMP))
    dw = (dout[rcv].to(d) * h[snd].to(d)).reshape(snd.numel(), heads, c).sum(2)
    dz = w * (dw - s.to(d)[rcv]) * dleaky(z, slope)
    dh = torch.zeros(h.shape, dtype=d, device=h.device).index_add_(
        0, snd, w.repeat_interleave(c, 1) * dout[rcv].to(d))
    dasrc = torch.zeros(alpha.shape, dtype=d, device=h.device).index_add_(0, snd, dz)
    return dh.float(), dasrc.float()


def check_gat_sender_split(kind: str, heads: int, c: int, dtype, close, gen):
    """gat_sender (dh, dasrc) on gat_sender_split_case(kind) at H heads of C
    columns, logits of a few units, alpha and S from the plain forward over
    the same graph's receiver CSR, against its plain function evaluated in
    f64 (`gat_sender_f64`); called twice and equal bit for bit (no
    atomics). close(name, got, want) holds a pair to the f32 bar of the
    backward's sums. The f64 evaluation, not the plain version's f32 one:
    its sums of node 0's 2,748 out-edges read up to 1.02 of that bar against
    the f64 ones on this graph, the kernel's split order up to 0.70 (CPU,
    PERF.md §6). Returns the largest error."""
    g, n_edge = gat_sender_split_case(kind)
    n, hc = g.n_node_pad, heads * c

    def rand(shape, dt, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * scale).to(dt)

    h, dout = rand((n, hc), dtype), rand((n, hc), dtype)
    asrc, adst = rand((n, heads), torch.float32, 2.0), rand((n, heads), torch.float32, 2.0)
    out, alpha = gfu.gat_fwd_plain(h, asrc, adst, g.senders, g.recv_row_ptr, g.n_edge, 0.2)
    s = (dout * out).float().reshape(n, heads, c).sum(2).contiguous()
    sa = (h, asrc, adst, alpha, s, dout, g.receivers_by_sender, g.send_row_ptr, n_edge, 0.2)
    got = gbw.gat_sender(*sa)
    tag = f"{kind} H={heads} C={c}"
    err = max(close(f"gat_sender split {tag} {w}", a, b)
              for w, a, b in zip(("dh", "dasrc"), got, gat_sender_f64(*sa)))
    again = gbw.gat_sender(*sa)
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError(f"gat_sender split {tag}: two calls differ")
    return err


# (row, edges) of spmm_split_graph's rows around spmm's piece: the main
# graph's hub in-degree at node 0 (43 pieces), one short of a piece, a piece
# and one past it; node 1 sends SPMM_SPLIT_SENDS edges (a heavy row of the
# sender CSR)
SPMM_SPLIT_ROWS = ((0, 2748), (2, spmm.PIECE - 1), (3, spmm.PIECE),
                   (4, spmm.PIECE + 1))
SPMM_SPLIT_SENDS = 300


def narrow_cases(device="cuda") -> dict:
    """name -> (ascending int32 receivers, segments) that the narrow sum's
    row pointer and split must take: a hub of 2,748 edges (the main
    graph's node 0) among light rows of 1-64 edges with empty rows between
    and padding past the last segment; a hub at edge 0; dropped edges
    (negative receivers) ahead of a hub that starts inside their chunk; rows
    of 64 (light) and 65 (heavy) edges, the last row heavy, edges past the
    end; every receiver past the end; no edge at all."""
    rng = np.random.default_rng(41)
    deg = np.minimum(rng.geometric(1 / 7, size=3000), 64) * (rng.random(3000) < 0.9)
    deg[0] = 2748
    cases = {
        "hub": (np.concatenate([np.repeat(np.arange(3000), deg),
                                np.full(93, 3000)]), 3001),
        "hub at head": (np.concatenate([np.zeros(130, int), np.arange(1, 50),
                                        np.full(9, 61)]), 60),
        "dropped then hub": (np.concatenate([np.full(10, -3), np.zeros(200, int),
                                             np.arange(1, 20)]), 20),
        "64 and 65": (np.concatenate([np.full(spmm.NARROW_PIECE, 2),
                                      np.full(spmm.NARROW_PIECE + 1, 3),
                                      np.full(70, 7), np.full(3, 9)]), 8),
        "all past": (np.full(40, 12), 10),
        "no edge": (np.zeros(0, int), 6),
    }
    return {k: (torch.from_numpy(r.astype(np.int32)).to(device), n)
            for k, (r, n) in cases.items()}


def narrow_f64(vals, receivers, num_segments: int):
    """sorted_segment_sum_narrow_plain's function with its sum in f64,
    rounded once to vals' dtype (the reference of the narrow checks on
    heavy rows, for the reason `spmm_f64` gives)."""
    keep = (receivers >= 0) & (receivers < num_segments)
    out = torch.zeros((num_segments, vals.shape[1]), dtype=torch.float64,
                      device=vals.device)
    out.index_add_(0, receivers[keep].long(), vals[keep].double())
    return out.to(vals.dtype)


def check_narrow(vals, receivers, num_segments: int, close) -> float:
    """The narrow kernel: its row pointer equal to torch.searchsorted's,
    its sums bit for bit the same in two calls and within `close` of the
    f64 reference. Returns close's error."""
    want_ptr = spmm.narrow_row_ptr_plain(receivers, num_segments)
    if not torch.equal(spmm.narrow_row_ptr(receivers, num_segments), want_ptr):
        raise AssertionError("narrow row pointer differs from torch.searchsorted")
    got = spmm.sorted_segment_sum_narrow(vals, receivers, num_segments)
    again = spmm.sorted_segment_sum_narrow(vals, receivers, num_segments)
    if not torch.equal(got, again):
        raise AssertionError("narrow sum differs between two calls")
    return close(got, narrow_f64(vals, receivers, num_segments))


def spmm_split_graph(device="cuda"):
    """A graph whose both CSRs hold rows spmm splits into pieces: the
    receiver rows of SPMM_SPLIT_ROWS, node 1's SPMM_SPLIT_SENDS out-edges,
    3,000 light edges over nodes 5-379, isolated nodes 380-399, and padding
    to a multiple of 1,024 edges, 928 padded edges that make the pad row
    heavy in both CSRs."""
    rng = np.random.default_rng(31)
    n = 400
    rcv = np.concatenate([np.full(d, r) for r, d in SPMM_SPLIT_ROWS]
                         + [rng.integers(5, 380, 3000),
                            rng.integers(5, 380, SPMM_SPLIT_SENDS)])
    snd = np.concatenate([rng.integers(0, 380, rcv.size - SPMM_SPLIT_SENDS),
                          np.ones(SPMM_SPLIT_SENDS, np.int64)])
    g = single_graph(snd, rcv, n_node=n, edge_pad_multiple=1024, device=device)
    if g.n_edge_pad - g.n_edge <= spmm.PIECE:
        raise AssertionError("spmm_split_graph: the pad row is light")
    return g


def spmm_f64(msgs, row_ptr, idx=None):
    """sorted_segment_sum_plain's function with its sum in f64, rounded once
    to msgs' dtype: the reference of the spmm checks on heavy rows. The plain
    version's f32 `index_add_` adds a row's terms in the order its atomics
    land, which changes from run to run on the card: against the kernel's
    fixed order, the main graph's 2,748-term hub row alone read 0.22, 0.75
    and 1.34 of the f32 bar in three runs of the same inputs and kernel
    (H100, PERF.md §6 PR 10)."""
    n = row_ptr.numel() - 1
    rows = segment_ids(row_ptr)
    e = rows.numel()  # the entries the kernel walks, [0, row_ptr[-1])
    src = msgs[:e] if idx is None else msgs.index_select(0, idx[:e].long())
    out = torch.zeros((n,) + tuple(msgs.shape[1:]), dtype=torch.float64,
                      device=msgs.device)
    return out.index_add_(0, rows, src.double()).to(msgs.dtype)


def gcn_agg_f64(hs, dinv, senders, recv_row_ptr):
    """gcn_agg_plain's function with its sum, self term and scale in f64,
    rounded once to hs' dtype (the reference of the gcn_agg checks on heavy
    rows, for the reason `spmm_f64` gives)."""
    agg = spmm_f64(hs.double(), recv_row_ptr, senders)
    return ((agg + hs.double()) * dinv.double()[:, None]).to(hs.dtype)


def check_spmm_split(g, d: int, dtype, close, gen):
    """sorted_segment_sum against its plain function evaluated in f64
    (`spmm_f64`) at D = d over g's receiver CSR with idx = senders (the
    gin/fastkan sum), its sender CSR with idx = receivers_by_sender (A^T dz)
    and the receiver CSR over messages without idx; each called twice and
    equal bit for bit (no atomics). close(name, got, want) holds a pair to
    the kernels' bar. Returns the largest error."""
    n, e = g.n_node_pad, g.n_edge_pad

    def rand(rows):
        return torch.randn((rows, d), generator=gen, device=gen.device).to(dtype)

    err = 0.0
    for name, args in (("receiver CSR", (rand(n), g.recv_row_ptr, g.senders)),
                       ("sender CSR", (rand(n), g.send_row_ptr, g.receivers_by_sender)),
                       ("receiver CSR, no idx", (rand(e), g.recv_row_ptr))):
        got = spmm.sorted_segment_sum(*args)
        err = max(err, close(f"spmm split {name} D={d}", got, spmm_f64(*args)))
        if not torch.equal(got, spmm.sorted_segment_sum(*args)):
            raise AssertionError(f"spmm split {name} D={d}: two calls differ")
    return err


# (spline order, grid size) of check_gin_split: the main paths' and the
# search space's largest
GIN_SPLIT_SHAPES = ((3, 4), (4, 16))


def gin_z_f64(x, senders, recv_row_ptr, eps: float):
    """The GIN kernels' f32 z exactly: the aggregate summed in f64, then
    (1+eps)*x, rounded once to f32 (their plain versions' f32 `index_add_`
    adds a heavy row's terms in its atomics' order, new each run)."""
    agg = spmm_f64(x.double(), recv_row_ptr, senders)
    return (agg + (1.0 + eps) * x.double()).float()


def gin_fastkan_f64(x, senders, recv_row_ptr, lng, lnb, w, wb, bb, eps: float,
                    grid_min: float = -2.0, grid_max: float = 2.0):
    """gin_fastkan_fwd_plain's function on the exactly summed z
    (`gin_z_f64`): (out, z) in x's dtype."""
    z32 = gin_z_f64(x, senders, recv_row_ptr, eps)
    return (fk.fastkan_forward_f32(z32, lng, lnb, w, wb, bb, grid_min, grid_max, x.dtype),
            z32.to(x.dtype))


def check_gin_split(g, d: int, o: int, dtype, close, gen, shape=(3, 4),
                    knots=None):
    """gin_kan_fwd at D = d, O = o and (spline order, grid size) `shape`
    over g's receiver CSR (spmm_split_graph: a 2,748-edge row, rows of
    63-65, the pad row heavy by its padding) against the plain KANLinear
    (`kan_forward_f32`) of the exactly summed z (the aggregate summed in f64,
    then (1+eps)*x, rounded once to f32): z of every row, the pad row's too,
    and out of the graph's rows (the pad row's output is unspecified, as in
    the JAX kernel); called twice and equal bit for bit (no atomics).
    close(name, got, want) holds a pair to the kernels' bar. The exact sum,
    not the plain version's own f32 one: on this graph, through the layer,
    the plain version's sum of node 0's 2,748 terms in edge order reads up
    to 1.16 of the f32 bar against the exact one, the kernel's pieces 0.06
    (CPU, PERF.md §6). `knots` (K, d) in `dtype` replaces the uniform grid
    (an adapted one). Returns the largest error."""
    k, grid = shape
    n = g.n_node_pad

    def rand(shape_, scale=1.0):
        return (torch.randn(shape_, generator=gen, device=gen.device) * scale).to(dtype)

    if knots is None:
        knots = make_grid(d, grid, k, device="cuda").t().contiguous().to(dtype)
    x, wb, ws = rand((n, d)), rand((d, o), 0.3), rand(((grid + k) * d, o), 0.3)
    ga = (x, g.senders, g.recv_row_ptr, knots, wb, ws, k, 0.25)
    got = gf.gin_kan_fwd(*ga)
    z32 = gin_z_f64(x, g.senders, g.recv_row_ptr, 0.25)
    want = bf.kan_forward_f32(z32, knots, wb, ws, k, dtype), z32.to(dtype)
    tag = f"order {k} grid {grid} D={d} O={o}"
    err = max(close(f"gin_fused split {tag} out", got[0][g.node_mask], want[0][g.node_mask]),
              close(f"gin_fused split {tag} z", got[1], want[1]))
    again = gf.gin_kan_fwd(*ga)
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError(f"gin_fused split {tag}: two calls differ")
    return err


def check_gin_fastkan_split(g, d: int, o: int, dtype, close, gen, num_grids: int = 4):
    """gin_fastkan_fwd at D = d, O = o and `num_grids` centers over g's
    receiver CSR (spmm_split_graph: a 2,748-edge row, rows of 63-65, the
    pad row heavy by its padding) against its plain function on the exactly
    summed z (`gin_fastkan_f64`): z of every row, the pad row's too, and out
    of the graph's rows (the pad row's output is unspecified, as in the JAX
    kernel); called twice and equal bit for bit (no atomics). close(name,
    got, want) holds a pair to the kernels' bar. Returns the largest
    error."""
    n, G = g.n_node_pad, num_grids

    def rand(shape_, scale=1.0):
        return (torch.randn(shape_, generator=gen, device=gen.device) * scale).to(dtype)

    x = rand((n, d))
    lw = (1.0 + rand((d,), 0.2), rand((d,), 0.1), rand((G * d, o), 0.3), rand((d, o), 0.3),
          rand((o,), 0.1))
    ga = (x, g.senders, g.recv_row_ptr, *lw, 0.25, -2.0, 2.0)
    got = gfk.gin_fastkan_fwd(*ga)
    want = gin_fastkan_f64(x, g.senders, g.recv_row_ptr, *lw, 0.25)
    tag = f"G={G} D={d} O={o}"
    err = max(close(f"gin_fastkan split {tag} out", got[0][g.node_mask],
                    want[0][g.node_mask]),
              close(f"gin_fastkan split {tag} z", got[1], want[1]))
    again = gfk.gin_fastkan_fwd(*ga)
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError(f"gin_fastkan split {tag}: two calls differ")
    return err


def profiled_kernels(fn, want: set) -> set:
    """The kernel names (utils/profiling.kernel_base_name) that fn() launches
    on the card, from torch.profiler: three calls a profile, profiled again,
    up to three times, while the names are not `want` (after many profiles
    in one process, profiles on the H100 came back without some or all of
    their kernels' events); the last profile's names."""
    from kagnn_tpu_torch.utils.profiling import device_profile, kernel_base_name

    for _ in range(3):
        prof = device_profile(lambda: [fn() for _ in range(3)], 3)
        names = {kernel_base_name(key) for key, _, _ in prof.kernels}
        if names == want:
            break
    return names


def rbf_bwd_kernels(x, w, dout, want: set) -> set:
    """profiled_kernels of rbf_spline_bwd(x, w, dout)."""
    return profiled_kernels(lambda: rf.rbf_spline_bwd(x, w, dout, -2.0, 2.0), want)


def gin_fused_expected(x) -> set:
    """The kernels gin_kan_fwd launches for x: the split aggregate's two, then
    the forward on the tensor cores where x is bf16, on the CUDA cores where
    it is f32."""
    fwd = "gin_fwd_mma_kernel" if x.dtype == torch.bfloat16 else "gin_fwd_kernel"
    return {"gin_sum_kernel", "gin_sum_combine_kernel", fwd}


def gin_fastkan_expected(x) -> set:
    """The kernels gin_fastkan_fwd launches for x: the split aggregate's two,
    then the layer on the tensor cores where x is bf16, on the CUDA cores
    where it is f32."""
    fwd = "gin_fastkan_fwd_mma_kernel" if x.dtype == torch.bfloat16 else "gin_fastkan_fwd_kernel"
    return {"gin_fastkan_sum_kernel", "gin_fastkan_sum_combine_kernel", fwd}


def rbf_fwd_expected(w) -> set:
    """The kernel rbf_spline_fwd launches for w: on the tensor cores where w
    is bf16 (x f32 or bf16), on the CUDA cores where it is f32."""
    return {"rbf_fwd_mma_kernel" if w.dtype == torch.bfloat16 else "rbf_fwd_kernel"}


GAT_SENDER_KERNELS = {"gat_sender_kernel", "gat_sender_combine_kernel"}


def rbf_bwd_expected(x, w, parts: int) -> set:
    """The kernels rbf_spline_bwd launches for x and w: on the tensor cores
    where w is bf16, on the CUDA cores where it is f32; the sum of the dx
    shares where the outputs come in several parts; the tile walk."""
    mma = w.dtype == torch.bfloat16
    names = {"rbf_dx_mma_kernel" if mma else "rbf_dx_kernel",
             "rbf_dw_mma_kernel" if mma else "rbf_dw_partial_kernel",
             "walk_tiles_kernel"}
    return names | ({"rbf_dx_sum_kernel"} if parts > 1 else set())


def graph_sum_batch(device="cuda"):
    """40 synthetic molecules (10-40 atoms, bond features) padded with 300
    pad nodes, 600 padded edges and 7 empty graphs: the receiver and sender
    CSRs' pad row holds 600 edges and the pad graph 300 nodes, heavy rows
    that the segment-sum kernel splits, as on the graph paths' batches."""
    from kagnn_tpu_torch.data.synthetic import random_molecule_graphs
    from kagnn_tpu_torch.graphs.batch import PadSpec, batch_graphs

    gs = random_molecule_graphs(40, 10, 40, seed=3, target="regression")
    n = sum(g["n_node"] for g in gs)
    e = sum(len(g["senders"]) for g in gs)
    return batch_graphs(gs, PadSpec(n + 300, e + 600, 48), device=device)


def check_graph_sums(g, d: int, dtype, close, gen):
    """The graph paths' segment sums through their autograd Functions
    against their functions summed in f64 (`spmm_f64`) at D = d: the pool
    (segment.segment_sum over graph_row_ptr, `SortedSegmentSum`), GINE's
    aggregate of per-edge messages over recv_row_ptr, and GINE's gradient to
    x (`SenderGather`'s backward over send_row_ptr with idx senders_perm);
    each twice and equal bit for bit. Returns the largest error."""
    from kagnn_tpu_torch.ops import segment

    def rand(rows):
        return torch.randn((rows, d), generator=gen, device=gen.device).to(dtype)

    x, msgs = rand(g.n_node_pad), rand(g.n_edge_pad)
    cot = rand(g.n_edge_pad)

    def gather_grad():
        xg = x.detach().clone().requires_grad_(True)
        segment.sender_gather(xg, g, fused=True).backward(cot)
        return xg.grad

    err = 0.0
    for name, run, want in (
            ("pool", lambda: segment.segment_sum(
                x, g.node_graph, g.n_graph_pad, g.graph_row_ptr, fused=True),
             spmm_f64(x, g.graph_row_ptr)),
            ("GINE aggregate", lambda: segment.segment_sum(
                msgs, g.receivers, g.n_node_pad, g.recv_row_ptr, fused=True),
             spmm_f64(msgs, g.recv_row_ptr)),
            ("GINE dx", gather_grad,
             spmm_f64(cot, g.send_row_ptr, g.senders_perm))):
        got = run()
        err = max(err, close(f"graph sum {name} D={d}", got, want))
        if not torch.equal(got, run()):
            raise AssertionError(f"graph sum {name} D={d}: two calls differ")
    return err


def check_prefetch(graphs, spec, batch_size: int, native, consume=None) -> int:
    """One shuffled pass of `batch_loader(prefetch=2)` on the card against
    the same seed's loader without prefetch (each batch assembled and moved
    when asked for), field by field and bit for bit; `consume(batch)` runs
    on each prefetched batch first (a train step: the consumer's stream
    works while the next copies land). Returns the number of batches."""
    import dataclasses

    from kagnn_tpu_torch.train.experiments import batch_loader

    kw = dict(shuffle=True, seed=1, native=native)
    sync = batch_loader(graphs, spec, batch_size, **kw)()
    n = 0
    for got in batch_loader(graphs, spec, batch_size, prefetch=2, **kw)():
        if consume is not None:
            consume(got)
        want = next(sync)
        for f in dataclasses.fields(got):
            a, b = getattr(got, f.name), getattr(want, f.name)
            same = (torch.equal(a, b) and a.dtype == b.dtype
                    and a.device == b.device) if isinstance(a, torch.Tensor) else a == b
            if not same:
                raise AssertionError(f"prefetched batch {n}: {f.name} differs "
                                     f"from the synchronously moved batch")
        n += 1
    if n != -(-len(graphs) // batch_size) or next(sync, None) is not None:
        raise AssertionError(f"prefetch yielded {n} batches")
    return n


# ------------------------------------------------------------ protocol layer

def check_lstsq(A, B, close=None) -> tuple[float, float]:
    """The card's least-squares solve (`bspline.lstsq` on A's device: the
    SVD with JAX's cutoff) against the CPU's `gelsd` on the same inputs.
    Both are minimum-norm solutions; the fit's residual |A X - B| (in f64)
    of the card's within 1e-6 of the CPU's, relative (the coefficients of
    an ill-conditioned system are determined only to about eps times its
    squared condition number; the residual is what least squares fixes);
    with close(name, got, want), the coefficients too. Returns (residual
    ratio - 1, coefficient error or 0)."""
    from kagnn_tpu_torch.kan.bspline import lstsq

    got = lstsq(A, B)
    want = lstsq(A.cpu(), B.cpu()).to(A.device)
    A64, B64 = A.double(), B.double()
    r_got = (A64 @ got.double() - B64).norm().item()
    r_want = (A64 @ want.double() - B64).norm().item()
    if not (torch.isfinite(got).all() and abs(r_got - r_want) <= 1e-6 * r_want + 1e-30):
        raise AssertionError(f"lstsq on the card: residual {r_got} against the "
                             f"CPU's {r_want}")
    err = close("lstsq coefficients", got, want) if close is not None else 0.0
    return r_got / max(r_want, 1e-30) - 1.0, err


def rank_deficient_system(device="cuda", seed: int = 0):
    """A batch of least-squares systems (4, 2000, 7) with a column of zeros
    (a basis without samples), two equal columns and zero rows (a sampled
    batch's pad rows), and right-hand sides (4, 2000, 3)."""
    gen = torch.Generator().manual_seed(seed)
    A = torch.randn(4, 2000, 7, generator=gen)
    A[:, :, 2] = 0.0
    A[:, :, 5] = A[:, :, 4]
    A[1, 1500:] = 0.0
    return A.to(device), torch.randn(4, 2000, 3, generator=gen).to(device)


def adapted_knots(d: int, grid: int, k: int, n: int = 4096, seed: int = 0,
                  device="cuda") -> torch.Tensor:
    """Knots (K, d) adapted by `bspline.update_grid` to n samples of a
    skewed distribution (exp of a normal: knots bunched near 0, spread far
    to the right), f32 on `device`: non-uniform knots, one grid a feature."""
    from kagnn_tpu_torch.kan.bspline import update_grid

    gen = torch.Generator().manual_seed(seed)
    x = torch.exp(torch.randn(n, d, generator=gen)) - 1.0
    w = torch.randn(3, d, grid + k, generator=gen)
    new_grid, _ = update_grid(x.to(device), make_grid(d, grid, k, device=device),
                              w.to(device), None, grid, k)
    return new_grid.t().contiguous()


def degenerate_knots(knots: torch.Tensor, features: int = 4) -> torch.Tensor:
    """`knots` (K, D) with knots 1 and 2 of the first `features` features
    moved to a and a + |a| * 2^-12, a a bf16 value between knots 0 and 3: a
    span finite in f32 and zero once the knots are rounded to bf16 (7 stored
    bits), as a grid adapted to tied samples can leave it."""
    t = knots.clone()
    a = ((t[0, :features] + t[3, :features]) / 2).to(torch.bfloat16).float()
    a = torch.where(a == 0, (t[3, :features] / 2).to(torch.bfloat16).float(), a)
    t[1, :features], t[2, :features] = a, a + a.abs() * 2.0 ** -12
    tb = t.to(torch.bfloat16)
    if not ((t[2] - t[1])[:features].gt(0).all()
            and (tb[2] == tb[1])[:features].all() and (t[1:] >= t[:-1]).all()):
        raise AssertionError("degenerate_knots: the narrowed spans are not as meant")
    return t


def close_nonfinite(name, got, want, close) -> tuple[float, int, int]:
    """got and want with the same non-finite entries (NaN where NaN, +inf
    and -inf where they are) and the finite ones by close(name, ...).
    Returns (error of the finite entries, NaN count, inf count)."""
    g, w = got.float(), want.float()
    for test in (torch.isnan, torch.isposinf, torch.isneginf):
        if not torch.equal(test(g), test(w)):
            raise AssertionError(
                f"{name}: {test.__name__} differs: {int(test(g).sum())} "
                f"entries on the card, {int(test(w).sum())} in the plain version")
    fin = torch.isfinite(w)
    err = close(name, g[fin], w[fin]) if fin.any() else 0.0
    return err, int(torch.isnan(w).sum()), int(torch.isinf(w).sum())


def check_adapted_layer(n: int, d: int, o: int, knots, dtype, close, gen,
                        k: int = 3, g=None) -> dict:
    """kan_linear_fwd, kan_linear_bwd and (with a graph g, finite knots
    only: `check_gin_split` reads no non-finite value) gin_kan_fwd on
    the knots (K, d) (rounded to `dtype`, as the layer casts its grid under
    a compute dtype) against their plain versions, non-finite entries
    included (`close_nonfinite`); a bf16 weight gradient of more than one
    tile by `check_bspline_bwd` (finite inputs only). Returns each output's
    (error, NaN count, inf count)."""
    grid = knots.shape[0] - 2 * k - 1
    t = knots.to(dtype)

    def rand(shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=gen.device) * scale).to(dtype)

    x, wb, ws = rand((n, d)), rand((d, o), 0.3), rand(((grid + k) * d, o), 0.3)
    dout = rand((n, o))
    out = {"fwd": close_nonfinite("kan_linear_fwd adapted", bf.kan_linear_fwd(x, t, wb, ws, k),
                                  bf.kan_linear_fwd_plain(x, t, wb, ws, k), close)}
    got = bf.kan_linear_bwd(x, t, wb, ws, dout, k)
    want = bf.kan_linear_bwd_plain(x, t, wb, ws, dout, k)
    finite = all(torch.isfinite(v).all() for v in want)
    if finite and dtype == torch.bfloat16 and -(-n // bf.JAX_TILE) > DW_CLOSE_TILES:
        out["bwd"] = (check_bspline_bwd("kan_linear_bwd adapted", x, t, wb, ws, dout, k,
                                        close, log=lambda *a: None), 0, 0)
    else:
        for name, a, b in zip(("dx", "dwb", "dws"), got, want):
            out[name] = close_nonfinite(f"kan_linear_bwd adapted {name}", a, b, close)
    if g is not None:
        out["gin"] = (check_gin_split(g, d, o, dtype, close, gen, shape=(k, grid),
                                      knots=t), 0, 0)
    return out


# --- the halo entries of the fused GIN kernels ---------------------------------

HALO_EPS = 0.25


def halo_entry_graph(n: int = 600, shards: int = 4, hub: int = 300, seed: int = 0,
                     device="cpu"):
    """A graph for the halo entries' card checks: random edges, node 5
    (shard 0) sending `hub` edges into shard 1 (a heavy row of shard 1's
    sender CSR in the extended space, held by a halo row) and node
    n/shards + 8 (shard 1) receiving `hub` edges (a heavy receiver row).
    Shard 1 is an interior shard: its last row is a valid node."""
    rng = np.random.default_rng(seed)
    e = 4 * n
    B = -(-(n + 1) // shards)
    snd = np.concatenate([rng.integers(0, n, e), np.full(hub, 5),
                          rng.integers(0, n, hub)])
    rcv = np.concatenate([rng.integers(0, n, e), rng.integers(B + 8, 2 * B - 8, hub),
                          np.full(hub, B + 8)])
    return single_graph(snd, rcv, n_node=n, device=device)


def halo_shard(g, shards: int, shard: int, device="cuda"):
    """(plan, shard graph, extended rows) of one shard of g's halo plan
    (dist/halo.py), on `device`: the entries run on it with no process
    group, fed an extended table directly."""
    from kagnn_tpu_torch.dist.halo import build_halo_plan, shard_graph

    plan = build_halo_plan(g, shards)
    return plan, shard_graph(plan, shard, device=device), plan.block + shards * plan.halo


def _gin_z_ext_f64(x, ext, senders, recv_row_ptr, eps: float):
    """The halo entries' f32 z exactly: the aggregate of ext's rows over the
    receiver CSR (its valid edges) summed in f64, then (1+eps)*x, rounded
    once to f32."""
    agg = spmm_f64(ext.double(), recv_row_ptr, senders)
    return (agg + (1.0 + eps) * x.double()).float()


def check_halo_entry(kind: str, g, n_ext: int, d: int, o: int, dtype, close, gen,
                     shape=(3, 4), num_grids: int = 4, wrong_must_fail=False,
                     log=print, tag: str = "") -> float:
    """One halo entry (kind "kan": gin_kan_fused_halo's GinKanHalo, "fastkan":
    GinFastKanHalo) on shard graph g with an extended table of n_ext rows
    ([x; halo], random), at D = d, O = o in `dtype`, against its plain
    function: the forward (out of the shard's valid rows and z of every row)
    against the plain layer on the exactly summed z (`_gin_z_ext_f64`); the
    backward through the autograd Function: dz from the layer backward
    kernel against its plain version, with the weight gradients held by
    `check_bspline_bwd` / `check_fastkan_bwd` (`dw_walk_check` past one bf16
    row tile), dx = (1+eps)*dz exactly and against the plain dz's, dext
    against the sender segment sum of dz in f64 (`spmm_f64`: the heavy-row
    convention); the forward and the Function's gradients twice, equal bit
    for bit. close(name, got, want) holds a pair to the kernels' bar.
    Returns the largest errors by the kernel that made them: "forward" (the
    fused GIN kernel), "layer_bwd" (the layer backward: dz, the weight
    gradients, dx) and "dext" (the segment sum)."""
    B = g.n_node_pad
    eps = HALO_EPS

    def rand(shape_, scale=1.0):
        return (torch.randn(shape_, generator=gen, device=gen.device) * scale).to(dtype)

    ext = rand((n_ext, d))
    x = ext[:B].clone()
    dout = rand((B, o))
    name = f"halo {kind} {tag} D={d} O={o}".replace("  ", " ")
    if kind == "kan":
        k, grid = shape
        knots = make_grid(d, grid, k, device=gen.device).t().contiguous().to(dtype)
        w = (rand((d, o), 0.3), rand(((grid + k) * d, o), 0.3))
        fwd = lambda: gf.gin_kan_fwd(x, g.senders, g.recv_row_ptr, knots, *w, k, eps,  # noqa: E731
                                     ext=ext)
        z32 = _gin_z_ext_f64(x, ext, g.senders, g.recv_row_ptr, eps)
        want = bf.kan_forward_f32(z32, knots, *w, k, dtype), z32.to(dtype)
        fn = lambda xr, er, wr: gf.GinKanHalo.apply(xr, er, g, knots, *wr, eps, k)  # noqa: E731
    else:
        G = num_grids
        w = (1.0 + rand((d,), 0.2), rand((d,), 0.1), rand((G * d, o), 0.3), rand((d, o), 0.3),
             rand((o,), 0.1))
        fwd = lambda: gfk.gin_fastkan_fwd(x, g.senders, g.recv_row_ptr, *w, eps, -2.0, 2.0,  # noqa: E731
                                          ext=ext)
        z32 = _gin_z_ext_f64(x, ext, g.senders, g.recv_row_ptr, eps)
        want = (fk.fastkan_forward_f32(z32, *w, -2.0, 2.0, dtype), z32.to(dtype))
        fn = lambda xr, er, wr: gfk.GinFastKanHalo.apply(xr, er, g, *wr, eps, -2.0, 2.0)  # noqa: E731
    got = fwd()
    valid = g.node_mask
    fwd_err = max(close(f"{name} out", got[0][valid], want[0][valid]),
                  close(f"{name} z", got[1], want[1]))
    if not all(torch.equal(a, b) for a, b in zip(got, fwd())):
        raise AssertionError(f"{name}: two forwards differ")
    z = got[1]
    if kind == "kan":
        err = check_bspline_bwd(f"{name} dz", z, knots, *w, dout, k, close,
                                wrong_must_fail, log)
        dz = bf.kan_linear_bwd(z, knots, *w, dout, k)[0]
        dz_plain = bf.kan_linear_bwd_plain(z, knots, *w, dout, k)[0]
    else:
        err = check_fastkan_bwd(f"{name} dz", z, w[0], w[1], w[2], w[3], dout,
                                close, wrong_must_fail, log)
        dz = fk.fastkan_layer_bwd(z, *w[:4], dout, -2.0, 2.0)[0]
        dz_plain = fk.fastkan_layer_bwd_plain(z, *w[:4], dout, -2.0, 2.0)[0]

    def grads():
        xr = x.clone().requires_grad_(True)
        er = ext.clone().requires_grad_(True)
        wr = tuple(t.clone().requires_grad_(True) for t in w)
        fn(xr, er, wr).backward(dout)
        return [xr.grad, er.grad] + [t.grad for t in wr]

    first = grads()
    if not all(torch.equal(a, b) for a, b in zip(first, grads())):
        raise AssertionError(f"{name}: two backwards differ")
    dx, dext = first[:2]
    if not torch.equal(dx, (1.0 + eps) * dz):
        raise AssertionError(f"{name}: dx is not (1+eps)*dz")
    return {"forward": fwd_err,
            "layer_bwd": max(err, close(f"{name} dx", dx, (1.0 + eps) * dz_plain)),
            "dext": close(f"{name} dext", dext,
                          spmm_f64(dz, g.send_row_ptr, g.receivers_by_sender))}


# --- the fused masked BatchNorm (kernels/masked_bn.py) -----------------------

def bar_ratio(got, want, dtype, scale=None) -> float:
    """max |got - want| / (c * scale), c 1e-4 in f32 and 4 bf16 ulps in
    bf16, scale |want| (or the given scale) floored by its mean: the card
    tests' `close` as a ratio, 1 at the bar."""
    got, want = got.float(), want.float()
    scale = (want.abs() if scale is None else scale.float()).expand_as(want)
    scale = scale.clamp_min(max(scale.mean().item(), 1e-30))
    c = 1e-4 if dtype == torch.float32 else 4 * BF16_ULP
    return ((got - want).abs() / (c * scale)).max().item()


def masked_bn_case(n: int, c: int, dtype, kind: str, gen, device="cuda"):
    """x (n, c) scaled and shifted (mean 3, spread 2), dy (n, c) in dtype,
    the mask (None, random with 70 % set, or all False) and a module with
    random weight, bias and running buffers, in training mode."""
    x = (torch.randn(n, c, generator=gen, device=device) * 2.0 + 3.0).to(dtype)
    dy = torch.randn(n, c, generator=gen, device=device).to(dtype)
    mask = {"none": None,
            "random": torch.rand(n, generator=gen, device=device) < 0.7,
            "all_false": torch.zeros(n, dtype=torch.bool, device=device)}[kind]
    bn = MaskedBatchNorm(c, device=device)
    with torch.no_grad():
        bn.weight.copy_(torch.randn(c, generator=gen, device=device) * 0.3 + 1.0)
        bn.bias.copy_(torch.randn(c, generator=gen, device=device) * 0.2)
        bn.running_mean.copy_(torch.randn(c, generator=gen, device=device))
        bn.running_var.copy_(torch.rand(c, generator=gen, device=device) + 0.5)
    return bn.train(), x, dy, mask


def masked_bn_f64(x, dy, mask, weight, eps: float) -> dict:
    """The training forward's statistics and the backward of
    MaskedBatchNorm in f64 from the same (rounded) inputs: mean, var, dx,
    dweight, dbias."""
    xd, g = x.double(), dy.double()
    m = (torch.ones_like(xd[:, :1]) if mask is None else mask.double()[:, None])
    n = m.sum().clamp_min(1.0)
    mean = (xd * m).sum(0) / n
    var = (((xd - mean) ** 2) * m).sum(0) / n
    rstd = torch.rsqrt(var + eps)
    xh = (xd - mean) * rstd
    w = weight.double()
    g = g * m
    db, dw = g.sum(0), (g * xh).sum(0)
    return {"mean": mean, "var": var, "dx": m * w * rstd * (g - db / n - xh * dw / n),
            "dweight": dw, "dbias": db}


def check_masked_bn(n: int, c: int, dtype, kind: str, gen) -> dict:
    """The fused forward and backward (MaskedBatchNorm on the card in
    training) against the plain version and the f64 function, raising past
    a bar (`bar_ratio`):
      * the running buffers against the plain version's, f32 bar;
      * y against the plain version's, x's bar over |x a| + |b| (a and b
        are rounded to x's dtype, so their last bit moves y by an ulp of
        x a); y bit for bit against x * a + b in PyTorch, given the fused
        forward's own a and b (the apply pass's rounding points);
      * dx against the f64 dx, x's bar (and the plain version's, n >= 4096:
        at fewer rows the plain dx is left with the cancellation of its
        terms); dweight and dbias against the f64 ones, f32 bar;
      * masked rows zero in y and dx; two calls equal bit for bit; two
        launches counted a call.
    Returns the ratios to the bars by name, and the largest absolute error
    of y against the plain version's and of dx, dweight and dbias against
    the f64 ones."""
    bn, x, dy, mask = masked_bn_case(n, c, dtype, kind, gen)
    state = {k: v.clone() for k, v in bn.state_dict().items()}

    def fused():
        bn.load_state_dict(state)
        xr = x.clone().requires_grad_(True)
        before = mbn.masked_bn.launches
        y = bn(xr, mask)
        # MaskedBatchNormFn saves (x, mask, weight, stats): a, b first
        stats = y.grad_fn.saved_tensors[3]
        y.backward(dy)
        if mbn.masked_bn.launches != before + 2:
            raise AssertionError("masked_bn: a forward and a backward did not count 2")
        out = {"y": y.detach(), "dx": xr.grad, "dweight": bn.weight.grad,
               "dbias": bn.bias.grad, "running_mean": bn.running_mean.clone(),
               "running_var": bn.running_var.clone(), "a": stats[:c].clone(),
               "b": stats[c:2 * c].clone()}
        bn.weight.grad = bn.bias.grad = None
        return out

    got = fused()
    again = fused()
    for k, v in got.items():
        if not torch.equal(v, again[k]):
            raise AssertionError(f"masked_bn: {k} differs between two calls")
    bn.load_state_dict(state)
    xp = x.clone().requires_grad_(True)
    yp = bn.plain(xp, mask, False)
    yp.backward(dy)
    ref = masked_bn_f64(x, dy, mask, bn.weight.detach(), bn.epsilon)
    a, bb = got["a"], got["b"]
    want = x * a.to(dtype) + bb.to(dtype)
    if mask is not None:
        want = torch.where(mask[:, None], want, torch.zeros((), dtype=dtype, device=x.device))
    if not torch.equal(got["y"], want):
        raise AssertionError("masked_bn: y differs from x * a + b given its own a and b")
    r = {"running_mean": bar_ratio(got["running_mean"], bn.running_mean, torch.float32),
         "running_var": bar_ratio(got["running_var"], bn.running_var, torch.float32),
         "y": bar_ratio(got["y"], yp, dtype, x.float().abs() * a.abs() + bb.abs()),
         "dx_f64": bar_ratio(got["dx"], ref["dx"], dtype),
         "dweight": bar_ratio(got["dweight"], ref["dweight"], torch.float32),
         "dbias": bar_ratio(got["dbias"], ref["dbias"], torch.float32)}
    if n >= 4096:
        r["dx_plain"] = bar_ratio(got["dx"], xp.grad, dtype)
    bad = {k: v for k, v in r.items() if not v <= 1.0}
    if bad:
        raise AssertionError(f"masked_bn ({n}, {c}) {dtype} {kind}: past the bar {bad}")
    if mask is not None and (got["y"][~mask].any() or got["dx"][~mask].any()):
        raise AssertionError("masked_bn: a masked row is not zero")
    err = max((got["y"].float() - yp.float()).abs().max().item(),
              *((got[k].double() - ref[k]).abs().max().item()
                for k in ("dx", "dweight", "dbias")))
    return r, err
