"""The CUDA kernels against their plain PyTorch versions on the card.

These tests need a CUDA device: the `card` fixture, used by every test
here, skips them with a reason on a machine without one (it decides when a
test runs, not when the module is imported). They import neither JAX nor
the test conftest's fixtures, so on a machine with a card and no JAX they
run with

    python -m pytest --noconftest tests/test_torch_cuda.py

Tolerance: each kernel rounds at the same points as its plain version and
only sums in another order. Elementwise |kernel - plain| <= c * max(|plain|,
mean |plain|) with c = 1e-4 in f32 and 4 bf16 ulps (4 * 2^-8) in bf16, where
a flipped final rounding costs one ulp; the mean floors the scale of values
near zero. A bf16 weight gradient summed over row tiles (the layer
backwards', rounded after every tile as the JAX kernels do) keeps that bar
over one tile; over more it is held to
`kernels/selfcheck.py::dw_walk_check`: 8 ulps of each element's
running-sum peak up to 331 tiles (growing with the square root of the
tiles past it), at most 1 % of the elements (or 2) differing."""
import numpy as np
import pytest
import torch

from kagnn_tpu_torch.graphs import single_graph
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
from kagnn_tpu_torch.kernels.selfcheck import (GAT_SPLIT_CASES,
                                               GIN_SPLIT_SHAPES,
                                               check_bspline_bwd,
                                               check_fastkan_bwd,
                                               check_gat_sender_split,
                                               check_gat_split,
                                               check_gin_split,
                                               check_spmm_split,
                                               fastkan_gcn_chain,
                                               gat_attention_chain,
                                               gcn_agg_f64, gcn_split_graph,
                                               rbf_bwd_expected,
                                               rbf_bwd_kernels, rbf_chain,
                                               spmm_split_graph)
from kagnn_tpu_torch.ops.segment import gcn_aggregate

pytestmark = pytest.mark.usefixtures("card")
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
# (D, O, grid size): the main path's width, ragged widths that leave part
# of a 32-feature chunk and a 64-column output tile empty, two output tiles
# (O > 64), more than 128 features (two passes of the gather), grids 3 and 5
SHAPES = [(16, 12, 4), (40, 100, 3), (200, 70, 5), (64, 64, 4)]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("the CUDA kernels run only on a CUDA device")


@pytest.fixture
def no_tf32():
    """TF32 off for one test's f32 products, restored after it."""
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = before


def close(got, want, dt):
    got, want = got.float(), want.float()
    c = 1e-4 if dt == "f32" else 4 * 2.0 ** -8
    scale = want.abs().clamp_min(max(want.abs().mean().item(), 1e-30))
    ratio = ((got - want).abs() / (c * scale)).max().item()
    assert ratio <= 1.0, ratio
    return (got - want).abs().max().item()


def _closer(dt):
    """close() as the selfcheck backward checks call it."""
    return lambda name, got, want: close(got, want, dt)


def _quiet(*_):
    pass


def _graph(seed, n=300, e=2000, f=16, hub=0):
    """A random graph; with hub > 0, node 0 also receives one edge from each
    of the first `hub` nodes (an in-degree above 256)."""
    rng = np.random.default_rng(seed)
    snd, rcv = rng.integers(0, n, e), rng.integers(0, n, e)
    if hub:
        snd = np.concatenate([snd, np.arange(hub)])
        rcv = np.concatenate([rcv, np.zeros(hub, np.int64)])
    return single_graph(snd, rcv,
                        nodes=rng.normal(size=(n, f)).astype(np.float32),
                        device="cuda")


def _layer(gen, d, o, grid, dtype, k=3):
    knots = make_grid(d, grid, k, device="cuda").t().contiguous().to(dtype)
    wb = (torch.randn(d, o, generator=gen, device="cuda") * 0.3).to(dtype)
    ws = (torch.randn((grid + k) * d, o, generator=gen, device="cuda")
          * 0.3).to(dtype)
    return knots, wb, ws


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_kernels_match_plain(dt, shape):
    D, O, grid = shape
    td = DTYPES[dt]
    gen = torch.Generator(device="cuda").manual_seed(0)
    g = _graph(1)
    knots, wb, ws = _layer(gen, D, O, grid, td)
    x = torch.randn(g.n_node_pad, D, generator=gen, device="cuda").to(td)
    dout = torch.randn(g.n_node_pad, O, generator=gen, device="cuda").to(td)

    args = (x, g.send_row_ptr, g.receivers_by_sender)
    close(spmm.sorted_segment_sum(*args), spmm.sorted_segment_sum_plain(*args), dt)
    msgs = x.index_select(0, g.senders.long())  # (E, D), receiver-sorted
    close(spmm.sorted_segment_sum(msgs, g.recv_row_ptr),
          spmm.sorted_segment_sum_plain(msgs, g.recv_row_ptr), dt)
    fa = (x, knots, wb, ws, 3)
    close(bf.kan_linear_fwd(*fa), bf.kan_linear_fwd_plain(*fa), dt)
    check_bspline_bwd(f"bspline_bwd {shape}", *fa[:4], dout, 3, _closer(dt))
    ga = (x, g.senders, g.recv_row_ptr, knots, wb, ws, 3, 0.25)
    nm = g.node_mask
    for a, b in zip(gf.gin_kan_fwd(*ga), gf.gin_kan_fwd_plain(*ga)):
        close(a[nm], b[nm], dt)


# (D, O, centers) of the FastKAN kernels: ragged widths, two output tiles,
# more than 128 features, 2 and 8 centers, and the main path's widths
FASTKAN_SHAPES = [(16, 12, 4), (40, 100, 2), (200, 70, 8), (64, 64, 4),
                  (128, 64, 4), (64, 40, 4)]


def _fastkan_layer(gen, d, o, G, dtype):
    """lng, lnb (D,), w (G*D, O), wb (D, O), bb (O,) in the kernel layouts."""
    def r(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * scale).to(dtype)
    return (1.0 + r(d, scale=0.2), r(d, scale=0.1), r(G * d, o, scale=0.3),
            r(d, o, scale=0.3), r(o, scale=0.1))


@pytest.mark.parametrize("shape", FASTKAN_SHAPES)
@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_new_kernels_match_plain(dt, shape):
    """gcn_agg, the FastKANLayer forward and backward (all six outputs) and
    gin_fastkan against their plain versions, on a graph with isolated
    nodes, a node of in-degree 301 and N not a multiple of any tile."""
    D, O, G = shape
    td = DTYPES[dt]
    gen = torch.Generator(device="cuda").manual_seed(1)
    g = _graph(4, n=301, e=900, hub=301)
    n = g.n_node_pad
    x = torch.randn(n, D, generator=gen, device="cuda").to(td)
    x[5] = 0.0  # a row of zeros: variance 0
    dout = torch.randn(n, O, generator=gen, device="cuda").to(td)
    dinv = torch.rsqrt(g.in_degrees.to(td) + 1.0).float()
    ga_args = (x, dinv, g.senders, g.recv_row_ptr)
    close(ga.gcn_agg_fwd(*ga_args, g.receivers), ga.gcn_agg_plain(*ga_args), dt)
    layer = _fastkan_layer(gen, D, O, G, td)
    fa = (x, *layer, -2.0, 2.0)
    close(fk.fastkan_layer_fwd(*fa), fk.fastkan_layer_fwd_plain(*fa), dt)
    check_fastkan_bwd("fastkan_bwd", x, *layer[:4], dout, _closer(dt), log=_quiet)
    gargs = (x, g.senders, g.recv_row_ptr, *layer, 0.25, -2.0, 2.0)
    nm = g.node_mask
    for a, b in zip(gfk.gin_fastkan_fwd(*gargs), gfk.gin_fastkan_fwd_plain(*gargs)):
        close(a[nm], b[nm], dt)


def test_new_autograd_functions_use_their_kernels():
    """FastKANLayerFn -> GcnAggregate -> GinFastKan chained: values and
    every gradient on the card equal the plain path on the CPU (f32, TF32
    off; rtol 1e-3 / atol 1e-5 as for gradients), and the GIN backward
    launches no segment sum when its input needs no gradient
    (kernels/selfcheck.py, which chip_smoke.py runs too)."""
    fastkan_gcn_chain(_graph(5, f=16))


# (H, C) of the GAT kernels: the main path's 4 x 64 (8 lanes a head), one
# head of 8 (one lane a head), 2 x 16, and 2 x 128 (16 lanes a head)
GAT_SHAPES = [(4, 64), (1, 8), (2, 16), (2, 128)]


@pytest.mark.parametrize("shape", GAT_SHAPES)
@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_gat_kernels_match_plain(dt, shape):
    """The GAT forward (out, alpha), dadst and sender (dh, dasrc) kernels
    against their plain versions on a graph with isolated nodes, a node of
    in-degree 301, N off every tile and 1,024-edge padding (many padded
    edges at the pad row, which must take no part), with logits of a few
    tens."""
    H, C = shape
    td = DTYPES[dt]
    gen = torch.Generator(device="cuda").manual_seed(2)
    rng = np.random.default_rng(6)
    snd = np.concatenate([rng.integers(0, 301, 900), np.arange(301)])
    rcv = np.concatenate([rng.integers(0, 280, 900), np.zeros(301, np.int64)])
    g = single_graph(snd, rcv, n_node=301, edge_pad_multiple=1024,
                     device="cuda")
    n = g.n_node_pad
    h = torch.randn(n, H * C, generator=gen, device="cuda").to(td)
    asrc, adst = (torch.randn(n, H, generator=gen, device="cuda") * 10
                  for _ in range(2))
    dout = torch.randn(n, H * C, generator=gen, device="cuda").to(td)
    fa = (h, asrc, adst, g.senders, g.recv_row_ptr, g.n_edge, 0.2)
    out, alpha = gfu.gat_fwd(*fa)
    for a, b in zip((out, alpha), gfu.gat_fwd_plain(*fa)):
        assert torch.isfinite(a).all()
        close(a, b, dt if a.dtype == td else "f32")
    s = (dout * out).float().reshape(n, H, C).sum(2).contiguous()
    ba = (h, asrc, adst, alpha, s, dout)
    close(gbw.gat_dadst(*ba, g.senders, g.recv_row_ptr, g.n_edge, 0.2),
          gbw.gat_dadst_plain(*ba, g.senders, g.recv_row_ptr, g.n_edge, 0.2),
          "f32")
    sa = (g.receivers_by_sender, g.send_row_ptr, g.n_edge, 0.2)
    for a, b in zip(gbw.gat_sender(*ba, *sa), gbw.gat_sender_plain(*ba, *sa)):
        close(a, b, "f32")
    lonely = (g.in_degrees == 0).nonzero()[:, 0]
    assert int(lonely[-1]) == n - 1  # the pad row: only its self-loop
    close(out[lonely], h[lonely], dt)


@pytest.mark.parametrize("kind", GAT_SPLIT_CASES)
@pytest.mark.parametrize("shape", GAT_SHAPES)
@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_gat_kernels_split_heavy_rows(dt, shape, kind):
    """gat_fwd and gat_dadst against their plain versions where they split
    receiver rows of more than 64 valid edges (kernels/selfcheck.py
    gat_split_case, which chip_smoke.py runs too): rows of 63, 64 and 65
    edges, two heavy rows starting inside one chunk, node 0's 2,748 edges,
    1,024-edge padding; n_edge cut inside a heavy row ("heavy": still
    heavy, its range running past n_edge; "light": 40 valid edges left).
    Each kernel twice, equal bit for bit."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    check_gat_split(kind, *shape, DTYPES[dt],
                    lambda name, got, want, k: close(got, want, k or dt), gen)


def test_gat_attention_function_uses_its_kernels():
    """GatAttention twice in a row: values and the gradients of h and of
    the attention vectors on the card equal the plain path on the CPU (f32,
    TF32 off; rtol 1e-3 / atol 1e-5), each kernel launched once per layer
    (kernels/selfcheck.py, which chip_smoke.py runs too)."""
    gat_attention_chain(_graph(7, f=8))


@pytest.mark.parametrize("shape", [(128, 256), (256, 256), (256, 40)])
@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_layer_backward_kernels_take_wide_outputs(dt, shape):
    """The B-spline and FastKAN backward kernels at GAT's widths (the
    transform's 256 = 4 heads x 64 outputs): the dx kernels stage the
    weights one 64-wide output tile at a time, so they run and match their
    plain versions. The walked bf16 weight gradients print their readings
    (6 B-spline tiles, 2 FastKAN tiles; `pytest -rP` shows them)."""
    D, O = shape
    td = DTYPES[dt]
    gen = torch.Generator(device="cuda").manual_seed(4)
    x = torch.randn(700, D, generator=gen, device="cuda").to(td)
    dout = torch.randn(700, O, generator=gen, device="cuda").to(td)
    knots, wb, ws = _layer(gen, D, O, 4, td)
    check_bspline_bwd(f"bspline_bwd {shape}", x, knots, wb, ws, dout, 3, _closer(dt))
    lw = _fastkan_layer(gen, D, O, 4, td)
    check_fastkan_bwd(f"fastkan_bwd {shape}", x, *lw[:4], dout, _closer(dt))


def test_kernels_count_their_launches():
    g = _graph(2, f=8)
    knots, wb, ws = _layer(torch.Generator(device="cuda").manual_seed(0),
                           8, 4, 4, torch.float32)
    x = g.nodes
    fns = (spmm.sorted_segment_sum, bf.kan_linear_fwd, bf.kan_linear_bwd,
           gf.gin_kan_fwd)
    before = [f.launches for f in fns]
    spmm.sorted_segment_sum(x, g.send_row_ptr, g.receivers_by_sender)
    bf.kan_linear_fwd(x, knots, wb, ws, 3)
    bf.kan_linear_bwd(x, knots, wb, ws, torch.ones(x.shape[0], 4, device="cuda"), 3)
    gf.gin_kan_fwd(x, g.senders, g.recv_row_ptr, knots, wb, ws, 3, 0.0)
    assert [f.launches - b for f, b in zip(fns, before)] == [1, 1, 1, 1]
    new = (ga.gcn_agg_fwd, fk.fastkan_layer_fwd, fk.fastkan_layer_bwd,
           gfk.gin_fastkan_fwd)
    before = [f.launches for f in new]
    layer = _fastkan_layer(torch.Generator(device="cuda").manual_seed(0),
                           8, 4, 4, torch.float32)
    ga.gcn_agg_fwd(x, torch.ones(x.shape[0], device="cuda"), g.senders,
                   g.recv_row_ptr, g.receivers)
    fk.fastkan_layer_fwd(x, *layer, -2.0, 2.0)
    fk.fastkan_layer_bwd(x, *layer[:4], torch.ones(x.shape[0], 4, device="cuda"),
                         -2.0, 2.0)
    gfk.gin_fastkan_fwd(x, g.senders, g.recv_row_ptr, *layer, 0.0, -2.0, 2.0)
    assert [f.launches - b for f, b in zip(new, before)] == [1, 1, 1, 1]
    gat = (gfu.gat_fwd, gbw.gat_dadst, gbw.gat_sender)
    before = [f.launches for f in gat]
    h = torch.randn(x.shape[0], 16, device="cuda")
    a = torch.randn(x.shape[0], 2, device="cuda")
    gfu.gat_fwd(h, a, a, g.senders, g.recv_row_ptr, g.n_edge, 0.2)
    gbw.gat_dadst(h, a, a, a, a, h, g.senders, g.recv_row_ptr, g.n_edge, 0.2)
    gbw.gat_sender(h, a, a, a, a, h, g.receivers_by_sender, g.send_row_ptr,
                   g.n_edge, 0.2)
    assert [f.launches - b for f, b in zip(gat, before)] == [1, 1, 1]
    slice4 = (rf.rbf_spline_fwd, rf.rbf_spline_bwd, spmm.sorted_segment_sum_narrow)
    before = [f.launches for f in slice4]
    w = torch.randn(8 * 8, 4, device="cuda")
    rf.rbf_spline_fwd(x, w, -2.0, 2.0)
    rf.rbf_spline_bwd(x, w, torch.ones(x.shape[0], 4, device="cuda"), -2.0, 2.0)
    spmm.sorted_segment_sum_narrow(torch.ones(g.n_edge_pad, 4, device="cuda"),
                                   g.receivers, x.shape[0])
    assert [f.launches - b for f, b in zip(slice4, before)] == [1, 1, 1]


def test_wrappers_reject_what_the_kernels_do_not_take():
    """Dtypes, layouts and alignment the kernels do not take raise, and so
    do the shapes the JAX kernels refuse too (one RBF center: its spacing
    divides by zero). The shapes these kernels refused before they took
    the experiment scripts' search spaces (spline order 1, 9 centers, 512 and 12-wide
    GAT heads, a backward whose rows once needed too much shared memory)
    now run and match their plain versions."""
    g = _graph(3, f=8)
    knots, wb, ws = _layer(torch.Generator(device="cuda").manual_seed(0),
                           8, 4, 4, torch.float32)
    x = g.nodes
    with pytest.raises(TypeError):
        bf.kan_linear_fwd(x.half(), knots.half(), wb.half(), ws.half(), 3)
    with pytest.raises(ValueError, match="contiguous"):
        bf.kan_linear_fwd(x.t().contiguous().t(), knots, wb, ws, 3)
    # spline order 1 (grid 4): the kernels run it
    k1 = _layer(torch.Generator(device="cuda").manual_seed(1), 8, 4, 4,
                torch.float32, k=1)
    close(bf.kan_linear_fwd(x, *k1, 1), bf.kan_linear_fwd_plain(x, *k1, 1), "f32")
    check_bspline_bwd("bspline_bwd order 1", x, *k1, torch.randn(
        x.shape[0], 4, device="cuda"), 1, _closer("f32"), log=_quiet)
    with pytest.raises(TypeError):
        spmm.sorted_segment_sum(x, g.send_row_ptr.long())
    gen = torch.Generator(device="cuda").manual_seed(0)
    with pytest.raises(ValueError, match="centers"):  # one center
        fk.fastkan_layer_fwd(x, *_fastkan_layer(gen, 8, 4, 1, torch.float32),
                             -2.0, 2.0)
    lw9 = _fastkan_layer(gen, 8, 4, 9, torch.float32)  # 9 centers run
    close(fk.fastkan_layer_fwd(x, *lw9, -2.0, 2.0),
          fk.fastkan_layer_fwd_plain(x, *lw9, -2.0, 2.0), "f32")
    with pytest.raises(TypeError):  # dinv reaches the kernel as f32
        ga.gcn_agg_fwd(x, torch.ones(x.shape[0], device="cuda").bfloat16(),
                       g.senders, g.recv_row_ptr, g.receivers)
    # the layer that needed more shared memory than a block has runs
    wide = _wide_layer(gen)
    check_fastkan_bwd("fastkan_bwd (400, 128)", wide[0], *wide[1:5], wide[5],
                      _closer("f32"), log=_quiet)
    # the GAT kernels take f32 asrc/adst; heads of any width (12 and 128
    # columns here) run
    h, a = torch.zeros(x.shape[0], 64, device="cuda"), torch.zeros(
        x.shape[0], 4, device="cuda")
    ga_args = (g.senders, g.recv_row_ptr, g.n_edge, 0.2)
    with pytest.raises(TypeError):
        gfu.gat_fwd(h, a.bfloat16(), a, *ga_args)
    for cols, heads in ((48, 4), (512, 4), (24, 2)):
        hh = torch.randn(x.shape[0], cols, device="cuda")
        aa = torch.randn(x.shape[0], heads, device="cuda")
        for got, want in zip(gfu.gat_fwd(hh, aa, aa, *ga_args),
                             gfu.gat_fwd_plain(hh, aa, aa, *ga_args)):
            close(got, want, "f32")
    # the RBF kernels take 2..32 centers (9 runs), dout in x's dtype; the
    # narrow sum at most 8 columns and int32 receivers
    with pytest.raises(ValueError, match="centers"):
        rf.rbf_spline_fwd(x, torch.zeros(8, 4, device="cuda"), -2.0, 2.0)
    w9 = torch.randn(9 * 8, 4, device="cuda") * 0.3
    close(rf.rbf_spline_fwd(x, w9, -2.0, 2.0),
          rf.rbf_spline_fwd_plain(x, w9, -2.0, 2.0), "f32")
    w = torch.zeros(4 * 8, 4, device="cuda")
    with pytest.raises(TypeError):
        rf.rbf_spline_bwd(x, w, torch.zeros(x.shape[0], 4, device="cuda").bfloat16(),
                          -2.0, 2.0)
    with pytest.raises(ValueError, match="1 <= k <= 8"):
        spmm.sorted_segment_sum_narrow(torch.zeros(g.n_edge_pad, 9, device="cuda"),
                                       g.receivers, x.shape[0])
    with pytest.raises(TypeError):
        spmm.sorted_segment_sum_narrow(torch.zeros(g.n_edge_pad, 4, device="cuda"),
                                       g.receivers.long(), x.shape[0])
    # the fused GCN aggregate takes no dtype but f32 and bf16 on the card:
    # fp16 raises instead of running the plain version
    launches = ga.gcn_agg_fwd.launches
    with pytest.raises(TypeError):
        gcn_aggregate(x.half(), g, torch.ones(x.shape[0], device="cuda"),
                      fused=True)
    assert ga.gcn_agg_fwd.launches == launches


def _wide_layer(gen, n=64, d=400, o=128, G=8):
    """A layer whose backward once needed more shared memory than a block
    has (its dx kernel held whole rows): x, lng, lnb, w, wb, dout."""
    lng, lnb, w, wb, _ = _fastkan_layer(gen, d, o, G, torch.float32)
    x = torch.randn(n, d, device="cuda")
    return x, lng, lnb, w, wb, torch.randn(n, o, device="cuda")


@pytest.mark.parametrize("conv,arch", [("gin", "kan"), ("gcn", "kan"),
                                       ("gcn", "fastkan"), ("gin", "fastkan"),
                                       ("gat", "kan"), ("gat", "fastkan")])
def test_step_kernel_path_matches_plain_path(conv, arch, no_tf32):
    """A small model per node path: the kernel path (fused=True) against
    the plain autograd path (fused=False) on the card, in f32 with TF32 off.
    Values rtol 1e-4 / atol 1e-5, gradients rtol 1e-3 / atol 1e-5."""
    from kagnn_tpu_torch.data import community_node_graph
    from kagnn_tpu_torch.models import NodeClassifier
    from kagnn_tpu_torch.train import masked_softmax_cross_entropy

    d = community_node_graph(n_nodes=200, n_classes=3, num_features=8, seed=0)
    g = single_graph(d["senders"], d["receivers"], nodes=d["nodes"], y=d["y"],
                     device="cuda")
    kw = dict(conv_type=conv, architecture=arch, mp_layers=3,
              num_features=8, hidden_channels=16, num_classes=3, skip=False)
    out = []
    for fused in (True, False):
        m = NodeClassifier(fused=fused, **kw)
        logits = m(g)
        masked_softmax_cross_entropy(logits, g.y, g.node_mask).backward()
        out.append((logits.detach(), {n: p.grad for n, p in m.named_parameters()}))
    (lk, gk), (lp, gp) = out
    nm = g.node_mask
    torch.testing.assert_close(lk[nm], lp[nm], rtol=1e-4, atol=1e-5)
    for n in gp:
        torch.testing.assert_close(gk[n], gp[n], rtol=1e-3, atol=1e-5, msg=n)


# (rows, D, O, centers) of the RBF kernels: one 256-row dW tile (N < 256),
# three 512-row tiles with a ragged last one, two output tiles (O > 64),
# more than 128 features, 2 centers, and the slice's widths
RBF_SHAPES = [(200, 6, 5, 4), (1300, 40, 100, 8), (1300, 200, 70, 2),
              (1300, 128, 64, 8), (1300, 64, 40, 8)]
RBF_DTYPES = [("f32", "f32"), ("f32", "bf16"), ("bf16", "bf16"), ("bf16", "f32")]


@pytest.mark.parametrize("shape", RBF_SHAPES)
@pytest.mark.parametrize("xw", RBF_DTYPES, ids=["-".join(p) for p in RBF_DTYPES])
def test_rbf_kernels_match_plain(xw, shape, no_tf32):
    """The RBF forward and backward (dx and the tile-ordered dW) against
    their plain versions, for x and w each in f32 or bf16; dx skipped when
    x needs none."""
    n, D, O, G = shape
    xd, wd = xw
    gen = torch.Generator(device="cuda").manual_seed(5)
    x = (torch.randn(n, D, generator=gen, device="cuda") * 1.5).to(DTYPES[xd])
    w = (torch.randn(G * D, O, generator=gen, device="cuda") * 0.3).to(DTYPES[wd])
    dout = torch.randn(n, O, generator=gen, device="cuda").to(DTYPES[xd])
    bf = "bf16" if "bf16" in xw else "f32"  # products of bf16 operands
    out = rf.rbf_spline_fwd(x, w, -2.0, 2.0)
    assert out.dtype == x.dtype
    close(out, rf.rbf_spline_fwd_plain(x, w, -2.0, 2.0), bf)
    (dx, dw), (pdx, pdw) = (f(x, w, dout, -2.0, 2.0) for f in (
        rf.rbf_spline_bwd, rf.rbf_spline_bwd_plain))
    assert dx.dtype == x.dtype and dw.dtype == w.dtype
    close(dx, pdx, bf)
    close(dw, pdw, wd if xd == wd else bf)
    dx2, dw2 = rf.rbf_spline_bwd(x, w, dout, -2.0, 2.0, need_dx=False)
    assert dx2 is None and torch.equal(dw2, dw)


@pytest.mark.parametrize("k", [1, 4, 8])
@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_narrow_kernel_matches_plain(dt, k):
    """The narrow segment sum over a graph's receivers (a node of in-degree
    301, isolated nodes, padded edges at the last row) and with edges past
    the last segment."""
    g = _graph(4, n=301, e=900, hub=301)
    gen = torch.Generator(device="cuda").manual_seed(6)
    vals = (torch.randn(g.n_edge_pad, k, generator=gen, device="cuda") * 10).to(DTYPES[dt])
    for segs in (g.n_node_pad, 250):
        close(spmm.sorted_segment_sum_narrow(vals, g.receivers, segs),
              spmm.sorted_segment_sum_narrow_plain(vals, g.receivers, segs), dt)


def test_rbf_function_uses_its_kernels():
    """RbfSplineMatmul twice in a row: values and the gradients of x and
    both weights on the card equal the plain path on the CPU (f32, TF32
    off; rtol 1e-3 / atol 1e-5), each kernel launched once per layer
    (kernels/selfcheck.py, which chip_smoke.py runs too)."""
    rbf_chain()


@pytest.mark.parametrize("kind", ["hub", "light"])
@pytest.mark.parametrize("D", [64, 128, 40, 42])
@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_gcn_agg_splits_heavy_rows(dt, D, kind):
    """gcn_agg against its plain function evaluated in f64 (`gcn_agg_f64`:
    the plain version's atomics add the hub row's terms in a new order each
    run) with a hub row of 100,000 in-edges (split into pieces that separate warps sum) and with every row
    light, at D 64 (16-byte loads, 8 lanes a bf16 row), 128, 40 (the head's
    width: 5 packs of 8 in bf16, 10 of 4 in f32) and 42 (not whole 16-byte
    packs in either dtype: one value a lane, 32 lanes a row); twice, equal
    bit for bit (no atomics)."""
    td = DTYPES[dt]
    g = gcn_split_graph(kind)
    gen = torch.Generator(device="cuda").manual_seed(9)
    hs = torch.randn(g.n_node_pad, D, generator=gen, device="cuda").to(td)
    dinv = torch.rsqrt(g.in_degrees.float() + 1.0)
    args = (hs, dinv, g.senders, g.recv_row_ptr)
    got = ga.gcn_agg_fwd(*args, g.receivers)
    close(got, gcn_agg_f64(*args), dt)
    assert torch.equal(got, ga.gcn_agg_fwd(*args, g.receivers))


# (D, O) of the layer forwards: the main paths' shapes (hidden, head, conv
# 0, the GAT transforms and head) and outputs the tensor-core kernels mask
# (1, 7: under one 8-wide n-tile; 40: five n-tiles) or split into parts of
# 256 (512), D off the 16-feature chunk (40)
FWD_SHAPES = [(64, 64), (64, 40), (128, 64), (128, 256), (256, 256), (256, 40),
              (64, 1), (64, 7), (40, 40), (64, 512)]


@pytest.mark.parametrize("shape", FWD_SHAPES, ids=[f"{d}x{o}" for d, o in FWD_SHAPES])
@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_layer_forwards_match_plain(dt, shape):
    """The B-spline and FastKAN layer forwards (bf16: the tensor-core
    kernels; f32: the CUDA-core ones) against their plain versions over
    1,000 rows (15 tiles of 64 and a ragged one), with a row of zeros."""
    D, O = shape
    td = DTYPES[dt]
    gen = torch.Generator(device="cuda").manual_seed(14)
    x = torch.randn(1000, D, generator=gen, device="cuda").to(td)
    x[3] = 0.0
    knots, wb, ws = _layer(gen, D, O, 4, td)
    fa = (x, knots, wb, ws, 3)
    close(bf.kan_linear_fwd(*fa), bf.kan_linear_fwd_plain(*fa), dt)
    fk_args = (x, *_fastkan_layer(gen, D, O, 4, td), -2.0, 2.0)
    close(fk.fastkan_layer_fwd(*fk_args), fk.fastkan_layer_fwd_plain(*fk_args), dt)


FWD_KAN_CORNERS = [(1, 1), (2, 8), (4, 16)]


@pytest.mark.parametrize("corner", FWD_KAN_CORNERS,
                         ids=[f"{k}-{g}" for k, g in FWD_KAN_CORNERS])
@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_bspline_forward_takes_the_corners(dt, corner):
    """The B-spline forward at spline order/grid (1, 1), (2, 8) and (4, 16)
    (2 to 21 groups: chunks of 32, 16 and 8 features on the tensor cores)
    at 500 features, at 7 and 512 outputs, and at D 40 over 301 rows."""
    k, grid = corner
    td = DTYPES[dt]
    gen = torch.Generator(device="cuda").manual_seed(15)
    for D, O in ((500, 64), (40, 7), (64, 512)):
        knots, wb, ws = _layer(gen, D, O, grid, td, k=k)
        x = torch.randn(301, D, generator=gen, device="cuda").to(td)
        fa = (x, knots, wb, ws, k)
        close(bf.kan_linear_fwd(*fa), bf.kan_linear_fwd_plain(*fa), dt)


@pytest.mark.parametrize("G", [2, 16, 32])
@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_fastkan_forward_takes_the_corners(dt, G):
    """The FastKAN forward at 2, 16 and 32 centers at PubMed's 500 and (32
    centers) CiteSeer's 3,703 features, at 7 and 512 outputs, over 301
    rows with a row of zeros."""
    td = DTYPES[dt]
    gen = torch.Generator(device="cuda").manual_seed(16)
    shapes = [(500, 64), (40, 7), (64, 512)] + ([(3703, 64)] if G == 32 else [])
    for D, O in shapes:
        x = torch.randn(301, D, generator=gen, device="cuda").to(td)
        x[5] = 0.0
        fa = (x, *_fastkan_layer(gen, D, O, G, td), -2.0, 2.0)
        close(fk.fastkan_layer_fwd(*fa), fk.fastkan_layer_fwd_plain(*fa), dt)


def test_forwards_route_by_dtype():
    """bf16 layer forwards launch the tensor-core kernels, f32 ones the
    CUDA-core kernels: the profiled kernel names (utils/profiling)."""
    from kagnn_tpu_torch.utils.profiling import device_profile, kernel_base_name

    gen = torch.Generator(device="cuda").manual_seed(17)
    for td, suffix in ((torch.bfloat16, "_fwd_mma_kernel"), (torch.float32, "_fwd_kernel")):
        x = torch.randn(500, 64, generator=gen, device="cuda").to(td)
        knots, wb, ws = _layer(gen, 64, 64, 4, td)
        lw = _fastkan_layer(gen, 64, 64, 4, td)
        for prefix, fn in (("bspline", lambda: bf.kan_linear_fwd(x, knots, wb, ws, 3)),
                           ("fastkan", lambda: fk.fastkan_layer_fwd(x, *lw, -2.0, 2.0))):
            fn()
            prof = device_profile(fn, 1)
            names = {kernel_base_name(key) for key, _, _ in prof.kernels}
            assert names == {prefix + suffix}, names


# (spline order, grid size) of the experiment scripts' search spaces: the smallest and
# largest orders and grids
KAN_CORNERS = [(1, 1), (2, 8), (4, 16), (1, 8)]


@pytest.mark.parametrize("corner", KAN_CORNERS, ids=[f"{k}-{g}" for k, g in KAN_CORNERS])
@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_bspline_kernels_take_the_search_space(dt, corner):
    """The B-spline forward, backward and gin_fused at spline order 1-4 and
    grid 1-16 (each a library of its own) against their plain versions, on
    a graph with a node of in-degree 301 and N off every tile, with ragged
    widths and two output tiles."""
    k, grid = corner
    td = DTYPES[dt]
    gen = torch.Generator(device="cuda").manual_seed(11)
    g = _graph(4, n=301, e=900, hub=301)
    for D, O in ((40, 100), (64, 64)):
        knots, wb, ws = _layer(gen, D, O, grid, td, k=k)
        x = torch.randn(g.n_node_pad, D, generator=gen, device="cuda").to(td)
        dout = torch.randn(g.n_node_pad, O, generator=gen, device="cuda").to(td)
        fa = (x, knots, wb, ws, k)
        close(bf.kan_linear_fwd(*fa), bf.kan_linear_fwd_plain(*fa), dt)
        check_bspline_bwd(f"bspline_bwd {corner}", *fa[:4], dout, k, _closer(dt),
                          log=_quiet)
        ga = (x, g.senders, g.recv_row_ptr, knots, wb, ws, k, 0.25)
        for a, b in zip(gf.gin_kan_fwd(*ga), gf.gin_kan_fwd_plain(*ga)):
            close(a[g.node_mask], b[g.node_mask], dt)


@pytest.mark.parametrize("corner", [(3, 4), (4, 16)], ids=["3-4", "4-16"])
def test_bspline_bf16_backward_takes_512_outputs(corner):
    """The bf16 backward at a GAT transform's widest outputs (4 heads x
    128): its dx kernel stages the weights in output parts where the whole
    chunk does not fit, its dW kernel the outputs."""
    k, grid = corner
    gen = torch.Generator(device="cuda").manual_seed(12)
    x = torch.randn(300, 32, generator=gen, device="cuda").bfloat16()
    dout = torch.randn(300, 512, generator=gen, device="cuda").bfloat16()
    knots, wb, ws = _layer(gen, 32, 512, grid, torch.bfloat16, k=k)
    check_bspline_bwd(f"bspline_bwd {corner} O=512", x, knots, wb, ws, dout, k,
                      _closer("bf16"), log=_quiet)


# (D, O, centers): 2, 16 and 32 centers (one library each) at ragged widths
# and at PubMed's 500 features, CiteSeer's 3,703 at 32, and a GAT transform's
# 512 outputs at 32 (the dx kernels then take the outputs in parts)
FASTKAN_CORNERS = [(40, 100, 2), (40, 100, 16), (40, 100, 32), (500, 64, 2),
                   (500, 64, 16), (500, 64, 32), (3703, 64, 32), (64, 512, 32)]


@pytest.mark.parametrize("shape", FASTKAN_CORNERS,
                         ids=[f"D{d}-O{o}-G{g}" for d, o, g in FASTKAN_CORNERS])
@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_fastkan_kernels_take_the_search_space(dt, shape):
    """The FastKANLayer forward and backward (all six outputs), gin_fastkan
    and the RBF product (forward, dx, dW) at 2-32 centers and up to 3,703
    features against their plain versions, on a graph with a node of
    in-degree 301 and N off every tile."""
    D, O, G = shape
    td = DTYPES[dt]
    gen = torch.Generator(device="cuda").manual_seed(13)
    g = _graph(4, n=301, e=900, hub=301)
    n = g.n_node_pad
    x = torch.randn(n, D, generator=gen, device="cuda").to(td)
    x[5] = 0.0
    dout = torch.randn(n, O, generator=gen, device="cuda").to(td)
    layer = _fastkan_layer(gen, D, O, G, td)
    fa = (x, *layer, -2.0, 2.0)
    close(fk.fastkan_layer_fwd(*fa), fk.fastkan_layer_fwd_plain(*fa), dt)
    check_fastkan_bwd(f"fastkan_bwd {shape}", x, *layer[:4], dout, _closer(dt),
                      log=_quiet)
    gargs = (x, g.senders, g.recv_row_ptr, *layer, 0.25, -2.0, 2.0)
    for a, b in zip(gfk.gin_fastkan_fwd(*gargs), gfk.gin_fastkan_fwd_plain(*gargs)):
        close(a[g.node_mask], b[g.node_mask], dt)
    w = layer[2]
    close(rf.rbf_spline_fwd(x, w, -2.0, 2.0), rf.rbf_spline_fwd_plain(x, w, -2.0, 2.0), dt)
    for a, b in zip(rf.rbf_spline_bwd(x, w, dout, -2.0, 2.0),
                    rf.rbf_spline_bwd_plain(x, w, dout, -2.0, 2.0)):
        close(a, b, dt)


# (H, C): the experiment scripts' 4 heads at hidden 2, 37, 96 and 128 (H*C up to
# 512: two passes of 32 slots), one head of 37, and one head of 512
GAT_CORNERS = [(4, 2), (4, 37), (4, 96), (4, 128), (1, 37), (1, 512)]


@pytest.mark.parametrize("shape", GAT_CORNERS, ids=[f"{h}x{c}" for h, c in GAT_CORNERS])
@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_gat_kernels_take_any_head_width(dt, shape):
    """The GAT forward, dadst and sender kernels at heads of any width
    against their plain versions, on the graph of
    test_gat_kernels_match_plain."""
    H, C = shape
    td = DTYPES[dt]
    gen = torch.Generator(device="cuda").manual_seed(14)
    rng = np.random.default_rng(6)
    snd = np.concatenate([rng.integers(0, 301, 900), np.arange(301)])
    rcv = np.concatenate([rng.integers(0, 280, 900), np.zeros(301, np.int64)])
    g = single_graph(snd, rcv, n_node=301, edge_pad_multiple=1024, device="cuda")
    n = g.n_node_pad
    h = torch.randn(n, H * C, generator=gen, device="cuda").to(td)
    asrc, adst = (torch.randn(n, H, generator=gen, device="cuda") * 10 for _ in range(2))
    dout = torch.randn(n, H * C, generator=gen, device="cuda").to(td)
    fa = (h, asrc, adst, g.senders, g.recv_row_ptr, g.n_edge, 0.2)
    out, alpha = gfu.gat_fwd(*fa)
    for a, b in zip((out, alpha), gfu.gat_fwd_plain(*fa)):
        close(a, b, dt if a.dtype == td else "f32")
    s = (dout * out).float().reshape(n, H, C).sum(2).contiguous()
    ba = (h, asrc, adst, alpha, s, dout)
    close(gbw.gat_dadst(*ba, g.senders, g.recv_row_ptr, g.n_edge, 0.2),
          gbw.gat_dadst_plain(*ba, g.senders, g.recv_row_ptr, g.n_edge, 0.2), "f32")
    sa = (g.receivers_by_sender, g.send_row_ptr, g.n_edge, 0.2)
    for a, b in zip(gbw.gat_sender(*ba, *sa), gbw.gat_sender_plain(*ba, *sa)):
        close(a, b, "f32")


@pytest.mark.parametrize("shape", [(128, 64), (256, 256)], ids=["128x64", "256x256"])
def test_fastkan_bwd_walks_the_jax_tiles_at_the_transform_shapes(shape, no_tf32):
    """The bf16 FastKAN backward at 169,344 rows and the GIN conv-0 and GAT
    transform widths: each walked weight gradient meets the plain walk
    within the walk bar, and a round-once and an unrounded-partials reduce
    of the same partials fail it."""
    D, O = shape
    gen = torch.Generator(device="cuda").manual_seed(15)
    x = torch.randn(169_344, D, generator=gen, device="cuda").bfloat16()
    dout = (torch.randn(169_344, O, generator=gen, device="cuda") * 0.1).bfloat16()
    lw = _fastkan_layer(gen, D, O, 4, torch.bfloat16)
    check_fastkan_bwd(f"fastkan_bwd {shape}", x, *lw[:4], dout, _closer("bf16"),
                      wrong_must_fail=True, log=_quiet)


@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_layer_backwards_walk_the_jax_tiles_at_the_main_shape(dt, no_tf32):
    """The B-spline and FastKAN backwards at the main paths' 169,344 rows
    and (64, 64): 1,323 B-spline tiles of 128 rows and 331 FastKAN tiles of
    512. In bf16 each weight gradient meets the plain walk within the walk
    bar, and a round-once and an unrounded-partials reduce of the same
    partials fail it."""
    td = DTYPES[dt]
    n, D, O = 169_344, 64, 64
    gen = torch.Generator(device="cuda").manual_seed(10)
    x = torch.randn(n, D, generator=gen, device="cuda").to(td)
    dout = (torch.randn(n, O, generator=gen, device="cuda") * 0.1).to(td)
    knots, wb, ws = _layer(gen, D, O, 4, td)
    wrong = dt == "bf16"
    check_bspline_bwd("bspline_bwd", x, knots, wb, ws, dout, 3, _closer(dt),
                      wrong_must_fail=wrong, log=_quiet)
    lw = _fastkan_layer(gen, D, O, 4, td)
    check_fastkan_bwd("fastkan_bwd", x, *lw[:4], dout, _closer(dt),
                      wrong_must_fail=wrong, log=_quiet)


@pytest.mark.parametrize("D", [1, 7, 40, 42, 64, 128, 300])
@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_spmm_splits_heavy_rows(dt, D):
    """The segment sum against its plain function evaluated in f64 on a
    graph whose both CSRs
    hold rows of more than 64 edges (summed in pieces that separate warps
    sum, then combined in chunk order): a receiver row of 2,748 edges and
    rows of 63-65, a sender row of 316, the pad row heavy by its 928 padded
    edges; over the receiver CSR with idx = senders, the sender CSR with
    idx = receivers_by_sender and the receiver CSR without idx; D from one
    column to 300 (16-byte loads at 8-32 lanes a row where D fills whole
    packs, one value a lane where it does not); twice, equal bit for bit."""
    check_spmm_split(spmm_split_graph(), D, DTYPES[dt],
                     lambda name, got, want: close(got, want, dt),
                     torch.Generator(device="cuda").manual_seed(23))


# (rows, D, O, centers) of the RBF backward: 2-32 centers at odd D, one and
# 40 outputs, 2,048 outputs (several output parts of dx at every center
# count), and the base-free FastKAN's widths at 8 centers over 3 tiles
RBF_TC_SHAPES = [(300, 37, 1, 2), (300, 37, 40, 9), (300, 37, 2048, 2),
                 (300, 37, 2048, 32), (1300, 64, 64, 8), (1300, 128, 64, 8)]


@pytest.mark.parametrize("shape", RBF_TC_SHAPES,
                         ids=[f"n{n}-D{d}-O{o}-G{g}" for n, d, o, g in RBF_TC_SHAPES])
@pytest.mark.parametrize("xw", RBF_DTYPES, ids=["-".join(p) for p in RBF_DTYPES])
def test_rbf_bwd_tensor_cores(xw, shape, no_tf32):
    """The RBF backward (dx and the tile-ordered dW) against its plain
    version where its products run on the tensor cores (w bf16: x f32, the
    base-free FastKAN's dtypes, and x bf16) and on the CUDA cores (w f32),
    with the kernels each launches (profiled names): dx kernels cut wide
    outputs into parts and sum the parts' shares."""
    n, D, O, G = shape
    xd, wd = xw
    gen = torch.Generator(device="cuda").manual_seed(29)
    x = (torch.randn(n, D, generator=gen, device="cuda") * 1.5).to(DTYPES[xd])
    w = (torch.randn(G * D, O, generator=gen, device="cuda") * 0.3).to(DTYPES[wd])
    dout = torch.randn(n, O, generator=gen, device="cuda").to(DTYPES[xd])
    bf = "bf16" if "bf16" in xw else "f32"
    (dx, dw), (pdx, pdw) = (f(x, w, dout, -2.0, 2.0) for f in (
        rf.rbf_spline_bwd, rf.rbf_spline_bwd_plain))
    close(dx, pdx, bf)
    close(dw, pdw, wd if xd == wd else bf)
    parts = rf._bwd_plan(n, D, O, G, *(rf.dtype_code(t) for t in (x, w)))
    want = rbf_bwd_expected(x, w, parts)
    assert rbf_bwd_kernels(x, w, dout, want) == want
    assert (parts > 1) == (O == 2048)


@pytest.mark.parametrize("shape", GIN_SPLIT_SHAPES, ids=[f"{k}-{g}" for k, g in GIN_SPLIT_SHAPES])
@pytest.mark.parametrize("D", [7, 64, 128, 300])
@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_gin_fused_splits_heavy_rows(dt, D, shape):
    """gin_kan_fwd (out and z of every row) against its plain version where
    its aggregate splits receiver rows of more than 64 edges into pieces
    (kernels/selfcheck.py check_gin_split on spmm_split_graph, which
    chip_smoke.py runs too): a row of 2,748 edges, rows of 63-65, the pad
    row heavy by its 928 padded edges; D from 7 (one value a lane) to 300
    (several column slabs), at the main paths' (spline order, grid size)
    and the largest; twice, equal bit for bit."""
    check_gin_split(spmm_split_graph(), D, 64, DTYPES[dt],
                    lambda name, got, want: close(got, want, dt),
                    torch.Generator(device="cuda").manual_seed(37), shape)


@pytest.mark.parametrize("kind", GAT_SPLIT_CASES)
@pytest.mark.parametrize("shape", GAT_SHAPES)
@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_gat_sender_splits_heavy_sender_rows(dt, shape, kind):
    """gat_sender against its plain version where it splits sender rows of
    more than 64 valid edges (kernels/selfcheck.py gat_sender_split_case,
    which chip_smoke.py runs too): gat_split_case's edges reversed, node 0
    sending 2,748, rows sending 63-65 and 300, n_edge cut inside the last
    ("heavy": 200 valid, "light": 40); at heads of 8-128 columns (rows of
    several slabs where they pass a warp's 32 slots); twice, equal bit for
    bit. (chip_smoke.py checks the kernels it launches by name.)"""
    gen = torch.Generator(device="cuda").manual_seed(41)
    check_gat_sender_split(kind, *shape, DTYPES[dt],
                           lambda name, got, want: close(got, want, "f32"), gen)
