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
import json

import numpy as np
import pytest
import torch

from kagnn_tpu_torch.graphs import single_graph
from kagnn_tpu_torch.kernels import launch_counters
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
                                               check_gin_fastkan_split,
                                               check_gin_split,
                                               check_masked_bn,
                                               check_spmm_split,
                                               fastkan_gcn_chain,
                                               gat_attention_chain,
                                               check_graph_sums,
                                               check_halo_entry,
                                               check_narrow, check_prefetch,
                                               gcn_agg_f64, gcn_split_graph,
                                               graph_sum_batch,
                                               halo_entry_graph, halo_shard,
                                               masked_bn_case,
                                               narrow_cases,
                                               rbf_bwd_expected,
                                               rbf_bwd_kernels, rbf_chain,
                                               spmm_split_graph)
from kagnn_tpu_torch.models import NodeClassifier
from kagnn_tpu_torch.ops.segment import gcn_aggregate
from kagnn_tpu_torch.train import (make_node_multi_step, make_node_steps,
                                   masked_softmax_cross_entropy)
from kagnn_tpu_torch.train.loops import WARMUP_STEPS
from kagnn_tpu_torch.utils import profiling

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
# largest orders and grids; then past them, as the JAX kernels take any: order
# 5 and grid 24 (28 groups a feature: the bf16 dW kernel's basis in 16-feature
# chunks)
KAN_CORNERS = [(1, 1), (2, 8), (4, 16), (1, 8), (5, 4), (3, 24)]


@pytest.mark.parametrize("corner", KAN_CORNERS, ids=[f"{k}-{g}" for k, g in KAN_CORNERS])
@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_bspline_kernels_take_the_search_space(dt, corner):
    """The B-spline forward, backward and gin_fused at spline order 1-5 and
    grid 1-24 (each a library of its own) against their plain versions, on
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
# 512 outputs at 32 (the dx kernels then take the outputs in parts); 48
# centers, past the experiment scripts' 32 (the forward's chunks of 4
# features)
FASTKAN_CORNERS = [(40, 100, 2), (40, 100, 16), (40, 100, 32), (500, 64, 2),
                   (500, 64, 16), (500, 64, 32), (3703, 64, 32), (64, 512, 32),
                   (40, 100, 48), (500, 64, 48)]


@pytest.mark.parametrize("shape", FASTKAN_CORNERS,
                         ids=[f"D{d}-O{o}-G{g}" for d, o, g in FASTKAN_CORNERS])
@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_fastkan_kernels_take_the_search_space(dt, shape):
    """The FastKANLayer forward and backward (all six outputs), gin_fastkan
    and the RBF product (forward, dx, dW) at 2-48 centers and up to 3,703
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
# 512: two passes of 32 slots), one head of 37, and one head of 512; 8 heads
# of 512 (512 slots: 16 passes, walked in two groups of 8) and 2 heads of
# 2,048 (the widest head)
GAT_CORNERS = [(4, 2), (4, 37), (4, 96), (4, 128), (1, 37), (1, 512), (8, 512),
               (2, 2048)]


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


@pytest.mark.parametrize("kind", ["bspline", "fastkan"])
def test_layer_kernels_take_bf16_weights_beside_f32_x(kind, no_tf32):
    """The mixed pair of a layer whose parameters are bf16 and whose input
    is f32 (param_dtype=bfloat16 without a compute dtype), as the JAX
    kernels take it: the forward, dx and the GIN fusion point in f32 at the
    f32 bar, each parameter gradient in bf16, its tiles' f32 partials
    rounded to bf16 as they are walked (`dw_walk_check`)."""
    gen = torch.Generator(device="cuda").manual_seed(15)
    g = _graph(4, n=1100, e=3000, hub=301)  # 9 and 3 row tiles: walked
    n, mask = g.n_node_pad, g.node_mask
    x = torch.randn(n, 40, generator=gen, device="cuda")
    dout = torch.randn(n, 100, generator=gen, device="cuda")
    if kind == "bspline":
        layer = tuple(t.bfloat16() for t in _layer(gen, 40, 100, 4, torch.float32))
        fa = (x, *layer, 3)
        got = bf.kan_linear_fwd(*fa)
        assert got.dtype == torch.float32
        close(got, bf.kan_linear_fwd_plain(*fa), "f32")
        check_bspline_bwd("bspline_bwd mixed", x, *layer, dout, 3, _closer("f32"),
                          log=_quiet)
        ga = (x, g.senders, g.recv_row_ptr, *layer, 3, 0.25)
        pairs = zip(gf.gin_kan_fwd(*ga), gf.gin_kan_fwd_plain(*ga))
    else:
        layer = _fastkan_layer(gen, 40, 100, 8, torch.bfloat16)
        fa = (x, *layer, -2.0, 2.0)
        got = fk.fastkan_layer_fwd(*fa)
        assert got.dtype == torch.float32
        close(got, fk.fastkan_layer_fwd_plain(*fa), "f32")
        check_fastkan_bwd("fastkan_bwd mixed", x, *layer[:4], dout, _closer("f32"),
                          log=_quiet)
        ga = (x, g.senders, g.recv_row_ptr, *layer, 0.25, -2.0, 2.0)
        pairs = zip(gfk.gin_fastkan_fwd(*ga), gfk.gin_fastkan_fwd_plain(*ga))
    for a, b in pairs:
        close(a[mask], b[mask], "f32")


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


@pytest.mark.parametrize("corner", [(3, 4), (4, 16)], ids=["3-4", "4-16"])
@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_bspline_backward_takes_2048_outputs(dt, corner):
    """The B-spline backward at 2,048 outputs against its plain version
    (dx at the kernels' bar, the tile-walked bf16 dW at the walk bar over
    three 128-row tiles): its dx kernels stage whole rows of dout, which do
    not fit in a block there (except f32 at (4, 16)), so they take the
    outputs in parts (`bspline_fused.bwd_parts`) and sum the parts' shares
    in order."""
    k, grid = corner
    td = DTYPES[dt]
    gen = torch.Generator(device="cuda").manual_seed(43)
    O = 2048
    x = torch.randn(300, 40, generator=gen, device="cuda").to(td)
    dout = (torch.randn(300, O, generator=gen, device="cuda") * 0.1).to(td)
    knots, wb, ws = _layer(gen, 40, O, grid, td, k=k)
    assert (bf.bwd_parts(O, grid, k, td)[0] > 1) == (corner == (3, 4) or dt == "bf16")
    check_bspline_bwd(f"bspline_bwd {corner} O={O}", x, knots, wb, ws, dout, k,
                      _closer(dt), log=_quiet)


@pytest.mark.parametrize("G", [2, 8, 32])
@pytest.mark.parametrize("xd", ["f32", "bf16"])
def test_rbf_fwd_tensor_cores(xd, G, no_tf32):
    """The RBF forward where w is bf16 (x f32: the base-free FastKAN's
    dtypes; x bf16: the layernorm-free layer's), on the tensor cores
    (`rbf_fwd_mma_kernel`: the f32 basis as three bf16 terms, a bf16 x's
    rounded basis as one), against its plain version at 2, 8 and 32 centers:
    ragged D and N, one output, the head's 40 and 300 (two output parts of
    256); each output at the bar of x's dtype. chip_smoke.py checks the
    kernel it launches by its profiled name."""
    gen = torch.Generator(device="cuda").manual_seed(47)
    for n, D, O in ((1300, 37, 40), (301, 64, 1), (300, 16, 300)):
        x = (torch.randn(n, D, generator=gen, device="cuda") * 1.5).to(DTYPES[xd])
        w = (torch.randn(G * D, O, generator=gen, device="cuda") * 0.3).bfloat16()
        got = rf.rbf_spline_fwd(x, w, -2.0, 2.0)
        assert got.dtype == x.dtype
        close(got, rf.rbf_spline_fwd_plain(x, w, -2.0, 2.0), xd)


@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_gin_fastkan_splits_heavy_rows(dt, D):
    """gin_fastkan_fwd (out and z of every row) where its aggregate splits
    receiver rows of more than 64 edges into pieces, against its plain
    function on the exactly summed z (kernels/selfcheck.py
    check_gin_fastkan_split on spmm_split_graph, which chip_smoke.py runs
    too): a row of 2,748 edges, rows of 63-65, the pad row heavy by its 928
    padded edges; the layer on the tensor cores under bf16; twice, equal bit
    for bit."""
    check_gin_fastkan_split(spmm_split_graph(), D, 64, DTYPES[dt],
                            lambda name, got, want: close(got, want, dt),
                            torch.Generator(device="cuda").manual_seed(53))


@pytest.mark.parametrize("k", [1, 3, 4, 8])
@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("case", list(narrow_cases("cpu")))
def test_narrow_kernel_splits_heavy_rows(case, dt, k):
    """The narrow sum's row pointer pass against torch.searchsorted exactly
    and its sums against the plain function summed in f64, twice equal bit
    for bit (kernels/selfcheck.py check_narrow, which chip_smoke.py runs
    too): a hub of 2,748 edges among light rows and empty ones, a hub at
    edge 0, dropped edges ahead of a hub inside their chunk, rows of 64 and
    65 edges, receivers past the end, no edge at all; k 3 (12 and 6 bytes an
    edge: 4- and 2-byte loads) beside 1, 4 and 8."""
    rcv, n = narrow_cases()[case]
    gen = torch.Generator(device="cuda").manual_seed(59)
    vals = (torch.randn(rcv.numel(), k, generator=gen, device="cuda") * 10).to(DTYPES[dt])
    check_narrow(vals, rcv, n, lambda got, want: close(got, want, dt))


def test_narrow_kernel_takes_unaligned_values():
    """Values whose rows are not 16-byte aligned (a column slice copied to
    an offset) take the one-value loads and give the same sums."""
    rcv, n = narrow_cases()["hub"]
    base = torch.randn(rcv.numel() * 4 + 1, device="cuda")
    vals = base[1:].view(rcv.numel(), 4)
    assert vals.data_ptr() % 16
    close(spmm.sorted_segment_sum_narrow(vals, rcv, n),
          spmm.sorted_segment_sum_narrow(vals.clone(), rcv, n), "f32")


MLP_KW = dict(architecture="mlp", mp_layers=3, num_features=16,
              hidden_channels=16, num_classes=4, skip=False, heads=2)


def _small_node_graph():
    from kagnn_tpu_torch.data import community_node_graph

    d = community_node_graph(n_nodes=300, n_classes=4, num_features=16, seed=0)
    return single_graph(d["senders"], d["receivers"], nodes=d["nodes"],
                        y=d["y"], device="cuda")


@pytest.mark.parametrize("conv", ["gin", "gcn", "gat"])
def test_mlp_step_kernel_path_matches_plain(conv, no_tf32):
    """The MLP paths' kernel path (fused=True: the segment-sum, gcn_agg and
    GAT kernels, in f32 past gin's first aggregate) against their plain
    path (fused=False) on a small graph: f32 logits rtol 1e-4 / atol 1e-5,
    every gradient rtol 1e-3 / atol 1e-5; the bf16 kernel path within a
    mean relative error of 0.1 of the f32 plain path (the bar of the other
    paths' small steps in chip_smoke.py)."""
    g = _small_node_graph()

    def run(fused, cd=None):
        m = NodeClassifier(conv_type=conv, fused=fused, compute_dtype=cd,
                           device="cuda", **MLP_KW)
        logits = m(g)
        masked_softmax_cross_entropy(logits, g.y, g.node_mask).backward()
        return logits.detach(), {n: p.grad for n, p in m.named_parameters()}

    lk, gk = run(True)
    lp, gp = run(False)
    nm = g.node_mask
    torch.testing.assert_close(lk[nm], lp[nm], rtol=1e-4, atol=1e-5)
    for n in gp:
        torch.testing.assert_close(gk[n], gp[n], rtol=1e-3, atol=1e-5, msg=n)
    lb, _ = run(True, torch.bfloat16)
    assert ((lb[nm] - lp[nm]).abs().mean() / lp[nm].abs().mean()).item() < 0.1


STEP_PATHS = [(c, a) for a in ("mlp", "kan", "fastkan") for c in ("gin", "gcn", "gat")]


@pytest.mark.parametrize("conv,arch", STEP_PATHS)
def test_captured_steps_equal_eager_steps(conv, arch, no_tf32):
    """make_node_multi_step's CUDA graph of 3 bf16 steps, replayed twice,
    against 6 eager steps of the same model with the same Adam
    (capturable=True): the losses and every parameter bit for bit; against
    the default Adam within 4 bf16 ulps of the losses. The eager steps run
    under torch.cuda.set_sync_debug_mode("error"): no step syncs with the
    host. The counters see the warm-up and the 3 captured steps at the
    first call and nothing at a replay."""
    g = _small_node_graph()
    kw = dict(MLP_KW, conv_type=conv, architecture=arch, grid_size=4)

    def model():
        return NodeClassifier(fused=True, compute_dtype=torch.bfloat16,
                              device="cuda", **kw)

    def adam(m, capturable):
        return torch.optim.Adam(m.parameters(), lr=1e-3, capturable=capturable)

    fns = launch_counters()
    m2 = model()
    step, _ = make_node_steps(m2, adam(m2, True))
    before = {k: f.launches for k, f in fns.items()}
    torch.cuda.set_sync_debug_mode("error")
    try:
        eager = [step(g, g.node_mask)]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    per_step = {k: f.launches - before[k] for k, f in fns.items()}
    eager += [step(g, g.node_mask) for _ in range(5)]
    m1 = model()
    multi = make_node_multi_step(m1, adam(m1, True), 3)
    before = {k: f.launches for k, f in fns.items()}
    first = multi(g, g.node_mask)
    assert {k: f.launches - before[k] for k, f in fns.items()} == {
        k: (WARMUP_STEPS + 3) * n for k, n in per_step.items()}
    before = {k: f.launches for k, f in fns.items()}
    captured = torch.cat([first, multi(g, g.node_mask)])
    assert all(f.launches == before[k] for k, f in fns.items())
    assert torch.equal(captured, torch.stack(eager))
    for (n, a), (_, b) in zip(m1.state_dict().items(), m2.state_dict().items()):
        assert torch.equal(a, b), n
    m3 = model()
    step3, _ = make_node_steps(m3, adam(m3, False))
    default = torch.stack([step3(g, g.node_mask) for _ in range(6)])
    assert ((captured - default).abs() <= 4 * 2.0 ** -8 * default.abs()).all()


def test_multi_step_spans_around_a_real_capture_and_replay(tmp_path):
    """Two profiled calls of make_node_multi_step on the card: the first
    records MULTI_STEP_CAPTURE then MULTI_STEP_REPLAY inside its MULTI_STEP,
    the second MULTI_STEP_COPY_IN then MULTI_STEP_REPLAY; span_report gives
    the replays' kernels (launched by cudaGraphLaunch) to the replay span."""
    g = _small_node_graph()
    m = NodeClassifier(conv_type="gin", fused=True, device="cuda",
                       **dict(MLP_KW, architecture="kan"))
    multi = make_node_multi_step(m, torch.optim.Adam(m.parameters(), lr=1e-3,
                                                     capturable=True), 2)
    with profiling.trace(str(tmp_path / "t")):
        multi(g, g.node_mask)
        multi(g, g.node_mask)
        torch.cuda.synchronize()
    path = tmp_path / "t" / "trace.json"
    spans = sorted((e for e in json.loads(path.read_text())["traceEvents"]
                    if e.get("ph") == "X" and e.get("cat") == "user_annotation"
                    and e["name"].startswith("kagnn.multi_step")), key=lambda e: e["ts"])
    calls = [e for e in spans if e["name"] == profiling.MULTI_STEP]
    assert len(calls) == 2
    parts = [[e["name"] for e in spans if e["name"] != profiling.MULTI_STEP
              and c["ts"] <= e["ts"] < c["ts"] + c["dur"]] for c in calls]
    assert parts == [[profiling.MULTI_STEP_CAPTURE, profiling.MULTI_STEP_REPLAY],
                     [profiling.MULTI_STEP_COPY_IN, profiling.MULTI_STEP_REPLAY]]
    report = profiling.span_report(str(path))
    assert report[profiling.MULTI_STEP_REPLAY]["count"] == 2
    assert report[profiling.MULTI_STEP_REPLAY]["self_device_ms"] > 0
    assert report[profiling.MULTI_STEP_CAPTURE]["device_ms"] > 0  # the warm-up step


def test_eager_step_backward_kernels_reach_the_backward_span(tmp_path):
    """On the card autograd launches the backward's kernels from its own
    thread: span_report gives them to the main thread's STEP_BACKWARD, and
    the step's phases hold all of its device time."""
    g = _small_node_graph()
    m = NodeClassifier(conv_type="gat", fused=True, device="cuda",
                       compute_dtype=torch.bfloat16, **dict(MLP_KW, architecture="kan"))
    step, _ = make_node_steps(m, torch.optim.Adam(m.parameters(), lr=1e-3))
    step(g, g.node_mask)
    with profiling.trace(str(tmp_path / "t")):
        step(g, g.node_mask)
        torch.cuda.synchronize()
    r = profiling.span_report(str(tmp_path / "t" / "trace.json"))
    assert r[profiling.STEP_BACKWARD]["self_device_ms"] > 0
    assert r[profiling.KAN_LAYER]["device_ms"] > 0
    assert r[profiling.MESSAGE_PASSING]["device_ms"] > 0
    phases = sum(v["device_ms"] for k, v in r.items()
                 if k in (profiling.STEP_FORWARD, profiling.STEP_BACKWARD)
                 or k.startswith(profiling.OPTIMIZER_SPANS))
    assert phases + r[profiling.STEP]["self_device_ms"] == pytest.approx(
        r[profiling.STEP]["device_ms"], rel=0.05)


def test_multi_step_refuses_what_it_cannot_capture():
    """On the card make_node_multi_step raises for an Adam that keeps its
    step count on the host. What it once refused now runs: a call with
    other tensors of the captured shapes copies them into the capture's and
    replays (losses and parameters bit for bit with eager steps on them); a
    model with dropout 0.5 registers its generator with the graph (the
    masks eager steps from the same seed draw); a batch with another
    n_edge takes a capture of its own."""
    from kagnn_tpu_torch.data import community_node_graph

    g = _small_node_graph()
    m = NodeClassifier(conv_type="gcn", fused=True, device="cuda", **MLP_KW)
    with pytest.raises(ValueError, match="capturable=True"):
        make_node_multi_step(m, torch.optim.Adam(m.parameters(), lr=1e-3), 2)
    d = community_node_graph(n_nodes=300, n_classes=4, num_features=16, seed=0)
    nodes2 = np.random.default_rng(9).normal(size=d["nodes"].shape).astype(np.float32)
    g2 = single_graph(d["senders"], d["receivers"], nodes=nodes2, y=d["y"],
                      device="cuda")
    g3 = single_graph(d["senders"][:-7], d["receivers"][:-7], nodes=d["nodes"],
                      y=d["y"], device="cuda")
    assert g3.n_edge_pad == g.n_edge_pad and g3.n_edge != g.n_edge
    calls = [(g, g.node_mask), (g, g.node_mask.clone()), (g2, g2.node_mask),
             (g3, g3.node_mask)]
    for conv, arch, dropout in (("gcn", "mlp", 0.0), ("gin", "kan", 0.5),
                                ("gat", "kan", 0.5)):
        kw = dict(MLP_KW, conv_type=conv, architecture=arch, grid_size=4,
                  dropout=dropout)
        m1, m2 = (NodeClassifier(fused=True, compute_dtype=torch.bfloat16,
                                 device="cuda", **kw) for _ in range(2))
        multi = make_node_multi_step(m1, torch.optim.Adam(
            m1.parameters(), lr=1e-3, capturable=True), 2)
        step, _ = make_node_steps(m2, torch.optim.Adam(
            m2.parameters(), lr=1e-3, capturable=True))
        got = torch.cat([multi(*c) for c in calls])
        want = torch.stack([step(*c) for c in calls for _ in range(2)])
        assert torch.equal(got, want), (conv, arch, got, want)
        for (n, a), (_, b) in zip(m1.state_dict().items(), m2.state_dict().items()):
            assert torch.equal(a, b), (conv, arch, n)
        assert len(multi.captures) == 2, (conv, arch)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("d", [8, 21, 64])
def test_graph_sums_split_heavy_pad_rows(dt, d):
    """The pool, GINE's aggregate and GINE's gradient to x through their
    autograd Functions against their functions summed in f64, on a batch
    whose pad row (600 padded edges) and pad graph (300 pad nodes) are
    heavy rows of the split; bit for bit twice."""
    g = graph_sum_batch()
    gen = torch.Generator(device="cuda").manual_seed(d)
    check_graph_sums(g, d, DTYPES[dt], _closer(dt), gen)


def _graph_classification_data(n=300):
    from kagnn_tpu_torch.data import random_molecule_graphs

    gs = random_molecule_graphs(n, 10, 40, seed=3)
    for g in gs:
        g["nodes"] = np.eye(21, dtype=np.float32)[g["nodes"][:, 0]]
        g["edges"] = None
    return gs


@pytest.mark.parametrize("native", [True, False], ids=["native", "numpy"])
def test_graph_prefetch_matches_sync_batches(native):
    """A shuffled pass of batch_loader(prefetch=2) equals the same seed's
    synchronously moved batches field by field, with a bf16 train step
    consuming each prefetched batch before it is compared."""
    from kagnn_tpu_torch.graphs import pad_spec_for
    from kagnn_tpu_torch.models import GraphClassifier
    from kagnn_tpu_torch.train import make_graph_cls_steps

    gs = _graph_classification_data()
    spec = pad_spec_for(gs, 64)
    m = GraphClassifier("gin", "kan", 2, 21, 16, 2, fused=True,
                        compute_dtype=torch.bfloat16, device="cuda")
    step, _ = make_graph_cls_steps(m, torch.optim.Adam(m.parameters(), lr=1e-3))
    assert check_prefetch(gs, spec, 64, native, consume=step) == 5


def test_graph_step_launches_per_step():
    """One bf16 step of graph classification gin/kan (3 convs) launches
    gin_fused 3, the layer forward 5 and backward 8 times, the segment
    sum 3 times (A^T dz at convs 1 and 2, the pool) and the fused
    BatchNorm 6 times (each conv's norm forward and backward)."""
    from kagnn_tpu_torch.graphs import batch_graphs, pad_spec_for
    from kagnn_tpu_torch.models import GraphClassifier
    from kagnn_tpu_torch.train import make_graph_cls_steps

    gs = _graph_classification_data(64)
    g = batch_graphs(gs, pad_spec_for(gs, 64))
    m = GraphClassifier("gin", "kan", 3, 21, 16, 2, fused=True,
                        compute_dtype=torch.bfloat16, device="cuda")
    step, _ = make_graph_cls_steps(m, torch.optim.Adam(m.parameters(), lr=1e-3))
    fns = launch_counters()
    before = {k: f.launches for k, f in fns.items()}
    assert torch.isfinite(step(g))
    torch.cuda.synchronize()
    assert {k: f.launches - before[k] for k, f in fns.items()
            if f.launches != before[k]} == {"gin_fused": 3, "bspline_fwd": 5,
                                            "bspline_bwd": 8, "spmm": 3,
                                            "masked_bn": 6}


# ------------------------------------------------------ the protocol layer

def test_protocol_lstsq_on_card_matches_gelsd():
    """The card's least-squares solve (the SVD, JAX's cutoff; never gels)
    against the CPU's gelsd: a rank-deficient system (a zero column, two
    equal columns, zero rows) at the f32 bar, and the refit system of a
    grid adapted to a batch of mostly zero pad rows (ill-conditioned) by
    its residual (`selfcheck.check_lstsq`)."""
    from kagnn_tpu_torch.kan.bspline import b_splines, update_grid
    from kagnn_tpu_torch.kernels.selfcheck import check_lstsq, rank_deficient_system

    A, B = rank_deficient_system()
    _, err = check_lstsq(A, B, close=_closer("f32"))
    assert torch.linalg.lstsq(A.cpu(), B.cpu(), driver="gelsd").solution[:, 2].abs().max() < 1e-5
    gen = torch.Generator(device="cuda").manual_seed(3)
    x = torch.zeros(4000, 16, device="cuda")
    x[:500] = torch.randn(500, 16, generator=gen, device="cuda")
    grid, _ = update_grid(x, make_grid(16, 8, 3, device="cuda"),
                          torch.randn(4, 16, 11, generator=gen, device="cuda"), None, 8, 3)
    A = b_splines(x, grid, 3).transpose(0, 1).contiguous()
    check_lstsq(A, torch.randn(16, 4000, 4, generator=gen, device="cuda"))


@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_protocol_kernels_on_adapted_knots(dt):
    """The B-spline forward, backward and gin_fused on knots adapted by
    update_grid (non-uniform, bunched near 0) against their plain versions;
    gin_fused over spmm_split_graph's heavy rows."""
    from kagnn_tpu_torch.kernels.selfcheck import adapted_knots, check_adapted_layer

    gen = torch.Generator(device="cuda").manual_seed(5)
    res = check_adapted_layer(3000, 64, 64, adapted_knots(64, 4, 3), DTYPES[dt],
                              _closer(dt), gen, g=spmm_split_graph())
    assert all(nan == 0 and inf == 0 for _, nan, inf in res.values())


@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_protocol_kernels_on_knots_bf16_rounds_together(dt):
    """Knots whose narrowest span is finite in f32 and zero in bf16: in
    bf16 the kernels give the plain versions' NaNs (0 * inf in the ladder),
    entry for entry; in f32 finite values within the bar."""
    from kagnn_tpu_torch.kernels.selfcheck import (adapted_knots, check_adapted_layer,
                                                   degenerate_knots)

    gen = torch.Generator(device="cuda").manual_seed(6)
    knots = degenerate_knots(adapted_knots(64, 4, 3))
    res = check_adapted_layer(128, 64, 40, knots, DTYPES[dt], _closer(dt), gen)
    nonfinite = sum(nan + inf for _, nan, inf in res.values())
    assert (nonfinite > 0) == (dt == "bf16")


@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_protocol_sampled_batch_kernels(dt):
    """A NeighborSampler batch (fanouts 10 and 5 around 256 seeds of a graph
    with a 2,000-edge hub; most padded edges in the pad row): spmm over both
    CSRs and gin_fused against their f64 sums."""
    from kagnn_tpu_torch.data import community_node_graph
    from kagnn_tpu_torch.data.sampling import NeighborSampler

    d = community_node_graph(n_nodes=6000, n_classes=4, num_features=8, seed=2)
    snd = np.concatenate([d["senders"], np.arange(1, 2001)])
    rcv = np.concatenate([d["receivers"], np.zeros(2000, np.int64)])
    sampler = NeighborSampler(snd, rcv, 6000, [10, 5], 256, seed=1, device="cuda")
    b = sampler.sample(np.arange(256), d["nodes"], d["y"])
    assert b.n_edge_pad - b.n_edge > spmm.PIECE
    gen = torch.Generator(device="cuda").manual_seed(7)
    check_spmm_split(b, 64, DTYPES[dt], _closer(dt), gen)
    check_gin_split(b, 64, 64, DTYPES[dt], _closer(dt), gen)


@pytest.mark.parametrize("capturable", [False, True])
def test_protocol_checkpoint_resume_on_card(capturable, tmp_path):
    """A bf16 gin/kan step resumed from a checkpoint into a fresh model and
    a fresh Adam (capturable: its step counts on the card) gives the
    uninterrupted run's losses and weights bit for bit."""
    from kagnn_tpu_torch.train import checkpoint

    g = _graph(3, n=500, e=3000)
    g = g.replace(y=torch.randint(0, 4, (g.n_node_pad,), device="cuda"))

    def fresh(seed):
        m = NodeClassifier("gin", "kan", 2, 16, 16, 4, fused=True,
                           compute_dtype=torch.bfloat16, seed=seed, device="cuda")
        return m, torch.optim.Adam(m.parameters(), lr=1e-3, capturable=capturable)

    m, opt = fresh(0)
    step, _ = make_node_steps(m, opt)
    whole = torch.stack([step(g, g.node_mask) for _ in range(6)])
    m, opt = fresh(0)
    step, _ = make_node_steps(m, opt)
    part = [step(g, g.node_mask) for _ in range(3)]
    checkpoint.save(str(tmp_path / "s.pt"), m, opt, step=3)
    m2, opt2 = fresh(1)
    assert checkpoint.restore(str(tmp_path / "s.pt"), m2, opt2) == 3
    step, _ = make_node_steps(m2, opt2)
    part += [step(g, g.node_mask) for _ in range(3)]
    assert torch.equal(whole, torch.stack(part))


# (shard, D, O) of the halo entries' checks on halo_entry_graph's 4-shard
# plan: shard 0 (the hub sender's owner) at ragged widths, shard 1 (an
# interior shard: its last row is a valid node and its padded edges point at
# it; a heavy receiver row and a heavy row of halo senders) at ragged and at
# the main path's widths
HALO_CASES = [(0, 16, 12), (1, 7, 5), (1, 64, 64)]


@pytest.mark.parametrize("case", HALO_CASES, ids=[f"shard{s}-{d}x{o}" for s, d, o in HALO_CASES])
@pytest.mark.parametrize("kind", ["kan", "fastkan"])
@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_dist_halo_entries_match_plain(dt, kind, case, no_tf32):
    """gin_kan_fused_halo's and gin_fastkan_fused_halo's kernels on one shard
    of a halo plan, fed an extended table directly (no process group),
    against their plain functions (`selfcheck.check_halo_entry`: the forward
    on the exactly summed z, dz and the weight gradients against the plain
    layer backward, dx, dext against the f64 sender sum, twice bit for
    bit)."""
    shard, d, o = case
    plan, g, n_ext = halo_shard(halo_entry_graph(device="cpu"), 4, shard)
    assert g.n_edge < g.n_edge_pad and n_ext > g.n_node_pad
    if shard == 1:
        assert bool(g.node_mask[-1])
    gen = torch.Generator(device="cuda").manual_seed(shard * 100 + d)
    check_halo_entry(kind, g, n_ext, d, o, DTYPES[dt], _closer(dt), gen, log=_quiet)


# ------------------------------------------------------ the fused BatchNorm

BN_ROWS = [1, 7, 4096, 169344]
BN_COLS = [1, 40, 64, 256, 300]


@pytest.mark.parametrize("kind", ["none", "random", "all_false"])
@pytest.mark.parametrize("c", BN_COLS)
@pytest.mark.parametrize("n", BN_ROWS)
@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_masked_bn_matches_plain(dt, n, c, kind):
    """MaskedBatchNorm's fused training forward and backward against its
    plain version and its f64 function (`selfcheck.check_masked_bn`): the
    running buffers, y, dx, dweight and dbias within their bars, y bit for
    bit against x * a + b given the forward's own a and b, masked rows zero,
    two calls equal bit for bit, two launches counted a call; from one row
    to the arxiv-sized graph's rows, at widths of one column, widths that
    no 16-byte vector fills (40 in bf16, 300) and the cells' widths."""
    gen = torch.Generator(device="cuda").manual_seed(n * 1000 + c)
    check_masked_bn(n, c, DTYPES[dt], kind, gen)


@pytest.mark.parametrize("dt,c", [("bf16", 64), ("f32", 256)])
def test_masked_bn_cuda_graph_equals_eager(dt, c):
    """The fused forward and backward at the two cells' shapes, captured in
    a CUDA graph and replayed twice, equal two eager calls bit for bit, the
    running buffers included; the eager calls never sync with the host."""
    gen = torch.Generator(device="cuda").manual_seed(c)
    bn, x, dy, mask = masked_bn_case(169344, c, DTYPES[dt], "random", gen)
    x.requires_grad_(True)
    state = {k: v.clone() for k, v in bn.state_dict().items()}

    def call():
        y = bn(x, mask)
        return (y.detach(),) + torch.autograd.grad(y, (x, bn.weight, bn.bias), dy)

    def buffers():
        return [bn.running_mean.clone(), bn.running_var.clone()]

    torch.cuda.set_sync_debug_mode("error")
    try:
        eager = [[t.clone() for t in call()] + buffers() for _ in range(2)]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    bn.load_state_dict(state)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        call()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = call()
    bn.load_state_dict(state)
    for want in eager:
        graph.replay()
        got = [t.clone() for t in out] + buffers()
        assert all(torch.equal(a, b) for a, b in zip(got, want))
