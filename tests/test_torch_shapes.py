"""The plain kernel versions against the JAX kernels in interpret mode at the
shapes the experiment scripts' search spaces reach (experiments/node_classification.py,
graph_classification.py, graph_regression.py), which the port's CUDA
kernels take since they stopped being compiled for a few shapes only:

  * the B-spline KANLinear forward and backward at (spline order, grid
    size) (1, 1), (2, 8) and (4, 16), and past the experiment scripts'
    search spaces, as the JAX kernels and now the port's take any shape, at
    (5, 4), (3, 24) and (5, 24); its bf16 backward at 512 outputs
    (a GAT transform of 4 heads x 128); the plan of the card's backward for
    any O up to 4,096 (its output parts);
  * the FastKANLayer forward and its six gradients, and the RBF spline
    product, at 2, 16, 32 and 48 centers and at 500 features (PubMed's
    width);
  * the GAT attention (forward, dadst and sender kernels) at 4 heads of 2,
    96 and 128 columns, one head of 37 (4 heads of 37 in the step below)
    and 8 heads of 512 (512 slots of 8 columns a row);
  * one bf16 train step (fused=True) of a small model per kernel family at
    a search-space corner: gin/kan at spline order 1 and grid 8,
    gin/fastkan at 32 centers, gat/kan at hidden width 37 with 4 heads.

On the CPU every wrapper runs its plain PyTorch version; the CUDA kernels
are held against those on the card (tests/test_torch_cuda.py,
chip_smoke.py). Tolerances are those of the kernel tests
(tests/test_torch_kernels.py, test_torch_fastkan.py, test_torch_rbf.py,
test_torch_gat.py, test_torch_node_paths.py): f32 values rtol 1e-4 / atol
1e-5 and gradients rtol 1e-3 / atol 1e-5 (of the output's scale where the
JAX kernel carries f32 operands as bf16 hi/lo pairs: GAT); bf16 4 ulps
(4 * 2^-8) of the output's scale per kernel, 4 for a step's logits and 8
for its gradients."""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kagnn_tpu.graphs import single_graph as jax_single_graph
from kagnn_tpu.kan import bspline as jbs
from kagnn_tpu.models import NodeClassifier as JaxNodeClassifier
from kagnn_tpu.ops import segment as jsegment
from kagnn_tpu.pallas import rbf_fused as jrbf
from kagnn_tpu.pallas.bspline_fused import bspline_kan_matmul
from kagnn_tpu.pallas.fastkan_layer import \
    fastkan_layer_fused as jax_fastkan_layer
from kagnn_tpu.pallas.gat_fused import gat_attention_fused
from kagnn_tpu.train import losses as jlosses
from kagnn_tpu_torch.data import community_node_graph
from kagnn_tpu_torch.graphs import single_graph
from kagnn_tpu_torch.kernels import bspline_fused as bf
from kagnn_tpu_torch.kernels import fastkan_layer as fk
from kagnn_tpu_torch.kernels import rbf_fused as rf
from kagnn_tpu_torch.kernels._common import SMEM_LIMIT
from kagnn_tpu_torch.models import NodeClassifier
from kagnn_tpu_torch.ops import segment
from kagnn_tpu_torch.train import masked_softmax_cross_entropy
from kagnn_tpu_torch.utils.port import from_jax_variables

torch.set_num_threads(1)

VAL = dict(rtol=1e-4, atol=1e-5)
GRAD = dict(rtol=1e-3, atol=1e-5)
BF16_ULP = 2.0 ** -8
SLOPE = 0.2
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _np32(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def close(got, want, dt, grad=False, err_msg="", scaled=False):
    """f32: elementwise rtol/atol (of the scale max |want| with `scaled`);
    bf16: 4 bf16 ulps of the scale."""
    got, want = _np32(got), _np32(want)
    assert got.shape == want.shape, (err_msg, got.shape, want.shape)
    if dt == "f32" and not scaled:
        np.testing.assert_allclose(got, want, err_msg=err_msg,
                                   **(GRAD if grad else VAL))
        return
    c = (GRAD if grad else VAL)["rtol"] if dt == "f32" else 4 * BF16_ULP
    tol = c * max(float(np.abs(want).max()), 1e-6)
    err = float(np.abs(got - want).max())
    assert err <= tol, f"{err_msg}: max err {err} > {tol}"


def _bspline(rng, n, d, o, k, g, dt):
    """The JAX kernel's forward and VJP, and the port's wrappers, on one
    layer of spline order k and grid size g."""
    jd, td = DTYPES[dt]
    knots = np.asarray(jbs.make_grid(d, g, k)).T.copy()
    wb = (rng.normal(size=(d, o)) * 0.3).astype(np.float32)
    ws = (rng.normal(size=(g + k, d, o)) * 0.3).astype(np.float32)
    x = rng.normal(size=(n, d)).astype(np.float32)
    dout = rng.normal(size=(n, o)).astype(np.float32)
    jargs = [jnp.asarray(a, jd) for a in (x, knots, wb, ws)]
    out_j, vjp = jax.vjp(lambda x_, wb_, ws_: bspline_kan_matmul(
        x_, jargs[1], wb_, ws_, k, True), jargs[0], jargs[2], jargs[3])
    grads_j = vjp(jnp.asarray(dout, jd))
    t = [torch.from_numpy(a).to(td) for a in (x, knots, wb, ws.reshape(-1, o))]
    out_t = bf.kan_linear_fwd(*t, k)
    grads_t = bf.kan_linear_bwd(*t, torch.from_numpy(dout).to(td), k)
    assert out_t.dtype == td and all(a.dtype == td for a in grads_t)
    close(out_t, out_j, dt, err_msg="out")
    for name, a, b in zip(("dx", "dwb", "dws"), grads_t, grads_j):
        close(a, np.asarray(_np32(b)).reshape(a.shape), dt, grad=True,
              err_msg=name)


# (dtype, spline order, grid size): the experiment scripts' smallest and largest
# orders and grids; the widest ladder in f32 (its arithmetic), whose
# rounding points are those of the others
BSPLINE_CORNERS = [("f32", 1, 1), ("bf16", 1, 1), ("f32", 2, 8), ("bf16", 2, 8),
                   ("f32", 4, 16), ("bf16", 5, 4), ("f32", 3, 24), ("f32", 5, 24)]


@pytest.mark.parametrize("dt,k,g", BSPLINE_CORNERS,
                         ids=[f"{d}-{k}-{g}" for d, k, g in BSPLINE_CORNERS])
def test_bspline_plain_matches_jax_at_search_space_corners(rng, dt, k, g):
    """Forward and backward (dx, dWb, dWs) over two JAX row tiles at the
    smallest and largest spline orders and grids of the experiment scripts."""
    _bspline(rng, 150, 8, 6, k, g, dt)


def test_bspline_bf16_backward_at_512_outputs(rng):
    """The bf16 backward at the GAT transform's widest outputs (4 heads x
    128), which the card's kernel stages in output parts."""
    _bspline(rng, 150, 4, 512, 3, 4, "bf16")


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("k,g", [(3, 4), (4, 16)], ids=["3-4", "4-16"])
def test_bspline_backward_output_parts_fit(dt, k, g):
    """The B-spline backward's output parts (`bwd_parts`, the plan the
    card's dx kernels take: each part's share of dx summed in order) at
    every O from 1 to 4,096: every part within a block's shared memory
    (`bwd_smem` of its width), the parts covering O with none empty, one
    part of every output wherever those fit (the kernels as before, no
    scratch), and several past the limit that once raised (in f32 about
    650 outputs at (3, 4), in bf16 about 1,650)."""
    td = torch.float32 if dt == "f32" else torch.bfloat16
    step = 16 if dt == "bf16" else 64
    for O in range(1, 4097):
        parts, width = bf.bwd_parts(O, g, k, td)
        assert bf.bwd_smem(width, g, k, td) <= SMEM_LIMIT, (O, width)
        assert (parts - 1) * width < O <= parts * width, (O, parts, width)
        whole = -(-O // 16) * 16 if dt == "bf16" else O
        if bf.bwd_smem(whole, g, k, td) <= SMEM_LIMIT:
            assert (parts, width) == (1, whole), O
        else:
            assert parts > 1 and width % step == 0, (O, parts, width)
    assert bf.bwd_parts(4096, g, k, td)[0] > 1
    if (k, g) == (3, 4):
        assert bf.bwd_parts(700 if dt == "f32" else 1700, g, k, td)[0] == 2


def _fastkan_weights(rng, d, o, G):
    """ln scale/bias (D,), spline weight (O, D*G), base weight (O, D),
    base bias (O,) in the module layouts."""
    return [(rng.normal(size=(d,)) * 0.2 + 1.0).astype(np.float32),
            (rng.normal(size=(d,)) * 0.1).astype(np.float32),
            (rng.normal(size=(o, d * G)) * 0.3).astype(np.float32),
            (rng.normal(size=(o, d)) * 0.3).astype(np.float32),
            (rng.normal(size=(o,)) * 0.1).astype(np.float32)]


# (rows, D, O, centers): the experiment scripts' fewest and most centers, 16, and
# PubMed's 500 features
FASTKAN_SHAPES = [(120, 12, 6, 2), (120, 12, 6, 16), (120, 12, 6, 32),
                  (64, 500, 8, 8), (120, 12, 6, 48)]


@pytest.mark.parametrize("shape", FASTKAN_SHAPES,
                         ids=[f"G{s[3]}-D{s[1]}" for s in FASTKAN_SHAPES])
@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_fastkan_layer_plain_matches_jax_at_search_space_corners(rng, dt, shape):
    """The whole layer and its VJP (dx, dlng, dlnb, dW, dWb, dbb) through
    the module layouts, against the JAX kernel in interpret mode."""
    jd, td = DTYPES[dt]
    n, d, o, G = shape
    x = rng.normal(size=(n, d)).astype(np.float32)
    x[7] = 0.0  # a row of zeros: variance 0, rstd finite
    dout = rng.normal(size=(n, o)).astype(np.float32)
    ws = _fastkan_weights(rng, d, o, G)
    jargs = [jnp.asarray(a, jd) for a in [x] + ws]
    out_j, vjp = jax.vjp(lambda *a: jax_fastkan_layer(
        *a, -2.0, 2.0, G, 4.0 / (G - 1), interpret=True), *jargs)
    grads_j = vjp(jnp.asarray(dout, jd))
    targs = [torch.from_numpy(a).to(td).requires_grad_(True) for a in [x] + ws]
    out_t = fk.fastkan_layer_fused(*targs, -2.0, 2.0, G)
    out_t.backward(torch.from_numpy(dout).to(td))
    assert out_t.dtype == td
    close(out_t, out_j, dt, err_msg="out")
    for name, a, b in zip(("dx", "dlng", "dlnb", "dsw", "dwb", "dbb"),
                          targs, grads_j):
        assert a.grad.dtype == td and torch.isfinite(a.grad).all()
        close(a.grad, b, dt, grad=True, err_msg=name)


@pytest.mark.parametrize("shape", FASTKAN_SHAPES,
                         ids=[f"G{s[3]}-D{s[1]}" for s in FASTKAN_SHAPES])
@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_rbf_plain_matches_jax_at_search_space_corners(rng, dt, shape):
    """rbf_spline_matmul (out, dx, dW) through the autograd Function
    against the JAX kernel in interpret mode, x and w in one dtype."""
    jd, td = DTYPES[dt]
    n, d, o, G = shape
    x = (rng.normal(size=(n, d)) * 1.5).astype(np.float32)
    w = (rng.normal(size=(G, d, o)) * 0.3).astype(np.float32)
    dout = rng.normal(size=(n, o)).astype(np.float32)
    jx, jw, jdo = (jnp.asarray(a, jd) for a in (x, w, dout))
    out_j, vjp = jax.vjp(lambda a, b: jrbf.rbf_spline_matmul(
        a, b, -2.0, 2.0, G, 4.0 / (G - 1), True), jx, jw)
    dx_j, dw_j = vjp(jdo)
    xt, wt = (torch.tensor(_np32(a)).to(td).requires_grad_(True)
              for a in (jx, jw.reshape(G * d, o)))
    out_t = rf.RbfSplineMatmul.apply(xt, wt, -2.0, 2.0)
    out_t.backward(torch.tensor(_np32(jdo)).to(td))
    close(out_t, out_j, dt, err_msg="out")
    close(xt.grad, dx_j, dt, grad=True, err_msg="dx")
    close(wt.grad, np.asarray(_np32(dw_j)).reshape(G * d, o), dt, grad=True,
          err_msg="dw")


# (dtype, heads, columns a head): GAT at hidden 2, 96 and 128 with the
# experiment scripts' 4 heads (H*C up to 512) and one head of 37; 4 heads of 37 run in
# the gat/kan step below. Each shape compiles the JAX kernels anew (about
# 9 s), so each runs in one dtype.
GAT_SHAPES = [("bf16", 4, 2), ("f32", 4, 96), ("bf16", 4, 128), ("f32", 1, 37),
              ("bf16", 8, 512)]


@pytest.mark.parametrize("dt,heads,c", GAT_SHAPES,
                         ids=[f"{d}-{h}x{c}" for d, h, c in GAT_SHAPES])
def test_gat_plain_matches_jax_at_head_widths(rng, dt, heads, c):
    """gat_attention(fused=True) (GatAttention over the plain forward,
    dadst and sender versions) against `gat_attention_fused` in interpret
    mode, which pads H*C to 128 lanes and splits its backward into 128-lane
    parts: values and the gradients in h, asrc and adst of a nonlinear
    loss, on a graph whose last 30 nodes receive no edge."""
    jd, td = DTYPES[dt]
    n0, e = 150, 700
    snd, rcv = rng.integers(0, n0, e), rng.integers(0, n0 - 30, e)
    gj = jax_single_graph(snd, rcv, n_node=n0, edge_pad_multiple=128)
    gt = single_graph(snd, rcv, n_node=n0, edge_pad_multiple=128, device="cpu")
    n, hc = gt.n_node_pad, heads * c
    h = _np32(jnp.asarray(rng.normal(size=(n, hc)), jd))
    att = (rng.normal(size=(heads, c)) * 0.3).astype(np.float32)
    amat = (att[:, :, None] * np.eye(heads)[:, None, :]).reshape(hc, heads)
    amat = _np32(jnp.asarray(amat, jd))
    asrc = _np32(jax.lax.dot_general(jnp.asarray(h, jd), jnp.asarray(amat, jd),
                                     (((1,), (0,)), ((), ())),
                                     preferred_element_type=jnp.float32))
    adst = rng.normal(size=(n, heads)).astype(np.float32)

    def jloss(a, b, d):
        o = gat_attention_fused(a, b, d, gj, SLOPE, True,
                                att_src_matrix=jnp.asarray(amat))
        o32 = o.astype(jnp.float32)
        return jnp.sum(o32 * jnp.cos(o32)), o

    (_, out_j), grads_j = jax.value_and_grad(
        jloss, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(h, jd), jnp.asarray(asrc), jnp.asarray(adst))
    ins = [torch.from_numpy(h).to(td), torch.from_numpy(asrc),
           torch.from_numpy(adst)]
    ins = [t.requires_grad_(True) for t in ins]
    out_t = segment.gat_attention(*ins, gt, SLOPE,
                                  att_src_matrix=torch.from_numpy(amat),
                                  fused=True)
    o32 = out_t.float()
    (o32 * torch.cos(o32)).sum().backward()
    assert out_t.dtype == td
    close(out_t, out_j, dt, err_msg="out", scaled=True)
    for name, a, b in zip(("dh", "dasrc", "dadst"), ins, grads_j):
        close(a.grad, b, dt, grad=True, err_msg=name, scaled=True)


# biases that feed a BatchNorm directly (the update nets here have one
# layer), and GAT gradients that sum nearly cancelling logit sensitivities
# (tests/test_torch_node_paths.py)
BN_FED_BIAS = re.compile(r"convs\.\d+\.(bias|update\.layers\.0\.base_linear\.bias)")
GAT_LOGIT_GRAD = re.compile(r"convs\.\d+\.(att_src|att_dst|transform\.base_linear\.bias)")
# (conv, architecture, the corner's settings) of the step test
CORNERS = [("gin", "kan", dict(spline_order=1, grid_size=8)),
           ("gin", "fastkan", dict(grid_size=32)),
           ("gat", "kan", dict(hidden_channels=37, heads=4))]


@pytest.mark.parametrize("conv,arch,corner", CORNERS,
                         ids=["gin-kan-order1-grid8", "gin-fastkan-G32",
                              "gat-kan-hidden37"])
def test_bf16_step_at_a_search_space_corner_matches_jax_fused(conv, arch, corner):
    """One bf16 train-mode forward and backward of a one-conv model (update
    nets of one layer), the
    port's kernel path (fused=True, plain versions on the CPU) against the
    JAX model's fused=True with its Pallas kernels in interpret mode, on
    weights carried by `utils/port.py`: logits to 4 bf16 ulps of their
    scale, every parameter gradient to 8 (the BatchNorm-fed biases and the
    GAT logit gradients as tests/test_torch_node_paths.py holds them)."""
    kw = dict(conv_type=conv, architecture=arch, mp_layers=1, num_features=8,
              hidden_channels=16, num_classes=3, grid_size=4, spline_order=3,
              skip=False, heads=2, hidden_layers=1)
    kw.update(corner)
    d = community_node_graph(n_nodes=80, n_classes=3, num_features=8, seed=3)
    gj = jax_single_graph(d["senders"], d["receivers"], nodes=d["nodes"],
                          y=d["y"])
    gt = single_graph(d["senders"], d["receivers"], nodes=d["nodes"],
                      y=d["y"], device="cpu")
    mask = np.zeros(gt.n_node_pad, bool)
    mask[:d["n_node"]] = d["masks"]["train"]
    with jsegment.use_pallas_spmm(False):
        v = JaxNodeClassifier(fused=False, **kw).init(jax.random.key(0), gj)
    jm = JaxNodeClassifier(fused=True, compute_dtype=jnp.bfloat16, **kw)

    def loss_fn(params):
        out, _ = jm.apply(dict(v, params=params), gj, train=True,
                          rngs={"dropout": jax.random.key(0)},
                          mutable=["batch_stats"])
        return jlosses.masked_softmax_cross_entropy(out, gj.y, mask), out

    with jsegment.use_pallas_spmm(True, interpret=True):
        (_, oj), grads_j = jax.value_and_grad(loss_fn, has_aux=True)(v["params"])
    m = NodeClassifier(fused=True, compute_dtype=torch.bfloat16, device="cpu", **kw)
    m.load_state_dict(from_jax_variables(jax.tree.map(np.asarray, v)))
    m.train()
    logits = m(gt)
    masked_softmax_cross_entropy(logits, gt.y, torch.from_numpy(mask)).backward()
    ot, oj = logits.detach().numpy(), np.asarray(oj)
    nm = gt.node_mask.numpy()
    assert np.isfinite(ot[nm]).all()
    assert np.abs(ot[nm] - oj[nm]).max() <= 4 * BF16_ULP * np.abs(oj[nm]).max()
    want = {k: t.numpy() for k, t in
            from_jax_variables({"params": grads_j}).items()}

    def conv_scale(name):
        c = name.split(".")[1]
        return max(np.abs(a).max() for k, a in want.items()
                   if k.startswith(f"convs.{c}."))

    for name, p in m.named_parameters():
        g, w = p.grad.numpy(), want[name]
        if BN_FED_BIAS.fullmatch(name):
            assert max(np.abs(g).max(), np.abs(w).max()) <= \
                8 * BF16_ULP * conv_scale(name), name
            continue
        err = np.abs(g - w).max()
        if conv == "gat" and GAT_LOGIT_GRAD.fullmatch(name):
            assert err <= 8 * BF16_ULP * conv_scale(name), (name, err)
            continue
        assert err <= 8 * BF16_ULP * np.abs(w).max(), (name, err)
