"""Port B-spline KAN (kagnn_tpu_torch/kan/) against the JAX package:
make_grid, b_splines, curve2coeff, and KANLinear / KAN values and gradients
on carried-over weights, against the JAX `fused=False` path.

Tolerances (f32): values rtol 1e-4 / atol 1e-5, gradients rtol 1e-3 /
atol 1e-5. Both sides compute the same f32 arithmetic and differ only in
summation order inside matrix products and segment sums; these bars are
tighter than the JAX package's own fused-versus-unfused ones
(tests/test_gin_fused.py)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kagnn_tpu.graphs import single_graph as jax_single_graph
from kagnn_tpu.kan import bspline as jbs
from kagnn_tpu.kan.layers import KAN as JKAN
from kagnn_tpu.kan.layers import KANLinear as JKANLinear
from kagnn_tpu.ops import segment as jsegment
from kagnn_tpu_torch.graphs import single_graph
from kagnn_tpu_torch.kan import KAN, KANLinear
from kagnn_tpu_torch.kan import bspline as tbs

torch.set_num_threads(1)

VAL = dict(rtol=1e-4, atol=1e-5)
GRAD = dict(rtol=1e-3, atol=1e-5)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("d,g,k", [(5, 4, 3), (3, 5, 2), (7, 3, 1)])
def test_make_grid_matches(d, g, k):
    np.testing.assert_array_equal(tbs.make_grid(d, g, k, (-1.5, 2.0)).numpy(),
                                  np.asarray(jbs.make_grid(d, g, k, (-1.5, 2.0))))


@pytest.mark.parametrize("nonuniform", [False, True])
def test_b_splines_matches(rng, nonuniform):
    d, g, k = 6, 4, 3
    grid = np.asarray(jbs.make_grid(d, g, k))
    if nonuniform:
        grid = (grid + rng.uniform(0, 0.15, grid.shape).cumsum(1) * 0.05
                ).astype(np.float32)
    x = rng.normal(size=(40, d)).astype(np.float32)
    want = np.asarray(jbs.b_splines(jnp.asarray(x), jnp.asarray(grid), k))
    got = tbs.b_splines(_t(x), _t(grid), k).numpy()
    np.testing.assert_allclose(got, want, **VAL)


def test_curve2coeff_matches(rng):
    d, g, k, o = 4, 4, 3, 3
    grid = np.asarray(jbs.make_grid(d, g, k))
    x = rng.uniform(-1, 1, size=(30, d)).astype(np.float32)
    y = rng.normal(size=(30, d, o)).astype(np.float32)
    want = np.asarray(jbs.curve2coeff(jnp.asarray(x), jnp.asarray(y),
                                      jnp.asarray(grid), k))
    got = tbs.curve2coeff(_t(x), _t(y), _t(grid), k).numpy()
    # least squares through two LAPACK routines: agreement to f32 solve noise
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-5)


def _load(module, params, buffers, prefix=""):
    sd = {prefix + k: _t(v) for k, v in params.items()}
    sd.update({prefix + k: _t(v) for k, v in buffers.items()})
    module.load_state_dict(sd)


def _grads_jax(loss, params, x):
    return jax.grad(loss, argnums=(0, 1))(params, x)


@pytest.mark.parametrize("fused", [False, True])
def test_kanlinear_values_and_grads(rng, fused):
    """Port KANLinear (plain autograd path, and the fused wrappers' plain
    versions on the CPU) against JAX fused=False on the same weights."""
    n, fin, fout = 33, 6, 5
    x = rng.normal(size=(n, fin)).astype(np.float32)
    jm = JKANLinear(fin, fout, grid_size=4, spline_order=3)
    v = jax.tree.map(np.asarray, jm.init(jax.random.key(0), jnp.asarray(x)))
    tm = KANLinear(fin, fout, grid_size=4, spline_order=3, fused=fused,
                   device="cpu")
    _load(tm, v["params"], v["buffers"])

    def jloss(params, x):
        o = jm.apply({"params": params, "buffers": v["buffers"]}, x)
        return jnp.sum(o * jnp.sin(o)), o

    (lj, oj), (gp, gx) = jax.value_and_grad(jloss, argnums=(0, 1),
                                            has_aux=True)(v["params"],
                                                          jnp.asarray(x))
    xt = _t(x).requires_grad_(True)
    ot = tm(xt)
    (ot * torch.sin(ot)).sum().backward()
    np.testing.assert_allclose(ot.detach().numpy(), np.asarray(oj), **VAL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), **GRAD)
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(gp[name]),
                                   err_msg=name, **GRAD)


def test_kanlinear_regularization_loss(rng):
    jm = JKANLinear(4, 3, grid_size=4)
    v = jax.tree.map(np.asarray, jm.init(jax.random.key(1), jnp.ones((2, 4))))
    tm = KANLinear(4, 3, grid_size=4, device="cpu")
    _load(tm, v["params"], v["buffers"])
    want = jm.apply(v, method=lambda m: m.regularization_loss(0.5, 2.0))
    np.testing.assert_allclose(tm.regularization_loss(0.5, 2.0).item(),
                               float(want), **VAL)


def test_kanlinear_init_shapes_and_generator():
    """Parameters are drawn from the generator: the same seed gives the
    same weights, the JAX shapes and a finite spline fit."""
    a = KANLinear(5, 4, grid_size=4, generator=torch.Generator().manual_seed(3),
                  device="cpu")
    b = KANLinear(5, 4, grid_size=4, generator=torch.Generator().manual_seed(3),
                  device="cpu")
    for (na, pa), (_, pb) in zip(a.state_dict().items(), b.state_dict().items()):
        assert torch.equal(pa, pb), na
    assert a.spline_weight.shape == (4, 5, 7) and a.grid.shape == (5, 11)
    assert torch.isfinite(a.spline_weight).all()


@pytest.mark.parametrize("fused", [False, True])
def test_kan_gin_fusion_point(rng, fused):
    """KAN with gin_graph=(g, eps): the GIN aggregate feeds the first layer.
    Against JAX fused=False under use_pallas_spmm(False); valid rows only,
    since the fused path leaves the masked last row unspecified."""
    n, e, f = 30, 120, 6
    snd, rcv = rng.integers(0, n, e), rng.integers(0, n, e)
    nodes = (rng.normal(size=(n, f)) * 0.5).astype(np.float32)
    gj = jax_single_graph(snd, rcv, nodes=nodes)
    gt = single_graph(snd, rcv, nodes=nodes, device="cpu")
    eps = 0.25
    jm = JKAN([f, 8, 4], grid_size=4, spline_order=3)
    x = jnp.asarray(gj.nodes)
    v = jax.tree.map(np.asarray, jm.init(jax.random.key(0), x,
                                         gin_graph=(gj, eps)))
    tm = KAN([f, 8, 4], grid_size=4, spline_order=3, fused=fused, device="cpu")
    sd = {}
    for i in range(2):
        for kk, a in {**v["params"][f"layers_{i}"],
                      **v["buffers"][f"layers_{i}"]}.items():
            sd[f"layers.{i}.{kk}"] = _t(a)
    tm.load_state_dict(sd)
    nm = np.asarray(gj.node_mask)

    def jloss(params, x):
        o = jm.apply({"params": params, "buffers": v["buffers"]}, x,
                     gin_graph=(gj, eps))
        return jnp.sum(jnp.where(gj.node_mask[:, None], o * jnp.cos(o), 0.0)), o

    with jsegment.use_pallas_spmm(False):
        (_, oj), (gp, gx) = jax.value_and_grad(jloss, argnums=(0, 1),
                                                has_aux=True)(v["params"], x)
    xt = gt.nodes.clone().requires_grad_(True)
    ot = tm(xt, gin_graph=(gt, eps))
    torch.where(gt.node_mask[:, None], ot * torch.cos(ot),
                torch.zeros(())).sum().backward()
    np.testing.assert_allclose(ot.detach().numpy()[nm], np.asarray(oj)[nm],
                               **VAL)
    np.testing.assert_allclose(xt.grad.numpy()[nm], np.asarray(gx)[nm], **GRAD)
    for name, p in tm.named_parameters():
        _, i, pn = name.split(".")
        np.testing.assert_allclose(p.grad.numpy(),
                                   np.asarray(gp[f"layers_{i}"][pn]),
                                   err_msg=name, **GRAD)
