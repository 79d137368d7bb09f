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
from kagnn_tpu_torch.kernels import gin_fused as gf
from kagnn_tpu_torch.kernels import spmm

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


def close(got, want, dt):
    got, want = got.float(), want.float()
    c = 1e-4 if dt == "f32" else 4 * 2.0 ** -8
    scale = want.abs().clamp_min(max(want.abs().mean().item(), 1e-30))
    ratio = ((got - want).abs() / (c * scale)).max().item()
    assert ratio <= 1.0, ratio


def _graph(seed, n=300, e=2000, f=16):
    rng = np.random.default_rng(seed)
    return single_graph(rng.integers(0, n, e), rng.integers(0, n, e),
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


def test_step_kernel_path_matches_plain_path():
    """A small gin/kan model: the kernel path (fused=True) against the
    plain autograd path (fused=False) on the card, in f32 with TF32 off.
    Values rtol 1e-4 / atol 1e-5, gradients rtol 1e-3 / atol 1e-5."""
    from kagnn_tpu_torch.data import community_node_graph
    from kagnn_tpu_torch.models import NodeClassifier
    from kagnn_tpu_torch.train import masked_softmax_cross_entropy

    torch.backends.cuda.matmul.allow_tf32 = False
    d = community_node_graph(n_nodes=200, n_classes=3, num_features=8, seed=0)
    g = single_graph(d["senders"], d["receivers"], nodes=d["nodes"], y=d["y"],
                     device="cuda")
    kw = dict(conv_type="gin", architecture="kan", mp_layers=3,
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
