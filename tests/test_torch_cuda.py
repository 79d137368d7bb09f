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
near zero."""
import numpy as np
import pytest
import torch

from kagnn_tpu_torch.graphs import single_graph
from kagnn_tpu_torch.kan.bspline import make_grid
from kagnn_tpu_torch.kernels import bspline_fused as bf
from kagnn_tpu_torch.kernels import fastkan_layer as fk
from kagnn_tpu_torch.kernels import gcn_agg as ga
from kagnn_tpu_torch.kernels import gin_fastkan as gfk
from kagnn_tpu_torch.kernels import gin_fused as gf
from kagnn_tpu_torch.kernels import spmm
from kagnn_tpu_torch.kernels.selfcheck import fastkan_gcn_chain
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
    for a, b in zip(bf.kan_linear_bwd(*fa[:4], dout, 3),
                    bf.kan_linear_bwd_plain(*fa[:4], dout, 3)):
        close(a, b, dt)
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
    close(ga.gcn_agg_fwd(*ga_args), ga.gcn_agg_plain(*ga_args), dt)
    layer = _fastkan_layer(gen, D, O, G, td)
    fa = (x, *layer, -2.0, 2.0)
    close(fk.fastkan_layer_fwd(*fa), fk.fastkan_layer_fwd_plain(*fa), dt)
    ba = (x, *layer[:4], dout, -2.0, 2.0)
    for a, b in zip(fk.fastkan_layer_bwd(*ba), fk.fastkan_layer_bwd_plain(*ba)):
        assert torch.isfinite(a).all()
        close(a, b, dt)
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
                   g.recv_row_ptr)
    fk.fastkan_layer_fwd(x, *layer, -2.0, 2.0)
    fk.fastkan_layer_bwd(x, *layer[:4], torch.ones(x.shape[0], 4, device="cuda"),
                         -2.0, 2.0)
    gfk.gin_fastkan_fwd(x, g.senders, g.recv_row_ptr, *layer, 0.0, -2.0, 2.0)
    assert [f.launches - b for f, b in zip(new, before)] == [1, 1, 1, 1]


def test_wrappers_reject_what_the_kernels_do_not_take():
    g = _graph(3, f=8)
    knots, wb, ws = _layer(torch.Generator(device="cuda").manual_seed(0),
                           8, 4, 4, torch.float32)
    x = g.nodes
    with pytest.raises(TypeError):
        bf.kan_linear_fwd(x.half(), knots.half(), wb.half(), ws.half(), 3)
    with pytest.raises(ValueError, match="contiguous"):
        bf.kan_linear_fwd(x.t().contiguous().t(), knots, wb, ws, 3)
    with pytest.raises(ValueError, match="spline order"):
        bf.kan_linear_fwd(x, knots[:-3].contiguous(), wb, ws, 3)
    big = torch.zeros(8, 130, device="cuda")
    with pytest.raises(ValueError, match="at most"):
        bf.kan_linear_bwd(x, knots, big, torch.zeros(56, 130, device="cuda"),
                          torch.zeros(x.shape[0], 130, device="cuda"), 3)
    with pytest.raises(TypeError):
        spmm.sorted_segment_sum(x, g.send_row_ptr.long())
    gen = torch.Generator(device="cuda").manual_seed(0)
    for G in (1, 9):  # the FastKAN kernels take 2..8 centers
        with pytest.raises(ValueError, match="centers"):
            fk.fastkan_layer_fwd(x, *_fastkan_layer(gen, 8, 4, G, torch.float32),
                                 -2.0, 2.0)
    with pytest.raises(TypeError):  # dinv reaches the kernel as f32
        ga.gcn_agg_fwd(x, torch.ones(x.shape[0], device="cuda").bfloat16(),
                       g.senders, g.recv_row_ptr)
    with pytest.raises(ValueError, match="shared memory"):
        fk.fastkan_layer_bwd(*_wide_layer(gen), -2.0, 2.0)
    # the fused GCN aggregate takes no dtype but f32 and bf16 on the card:
    # fp16 raises instead of running the plain version
    launches = ga.gcn_agg_fwd.launches
    with pytest.raises(TypeError):
        gcn_aggregate(x.half(), g, torch.ones(x.shape[0], device="cuda"),
                      fused=True)
    assert ga.gcn_agg_fwd.launches == launches


def _wide_layer(gen, n=64, d=400, o=128, G=8):
    """A layer whose backward needs more shared memory than a block has."""
    lng, lnb, w, wb, _ = _fastkan_layer(gen, d, o, G, torch.float32)
    x = torch.randn(n, d, device="cuda")
    return x, lng, lnb, w, wb, torch.randn(n, o, device="cuda")


@pytest.mark.parametrize("conv,arch", [("gin", "kan"), ("gcn", "kan"),
                                       ("gcn", "fastkan"), ("gin", "fastkan")])
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
