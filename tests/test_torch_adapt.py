"""Grid adaptation of the port (`kan/bspline.py::update_grid`, `lstsq`,
`kan/adapt.py`) against the JAX package's on the CPU.

Tolerance: f32 values rtol 1e-4 / atol 1e-5, the port's f32 bar: the same
arithmetic (quantile knots taken from the sorted samples, a batched
minimum-norm least-squares fit) in another summation order. The
rank-deficient fits (tied samples: bases with no sample) are held to the
same bar; both sides zero the singular values below eps * max(M, N) of the
largest, so a basis without samples gets a zero coefficient on both.

One case is held to another bar: a batch whose rows are mostly zero pad
rows at grids of 8-16 puts most adaptive knots at 0, a hair apart (the 2 %
uniform share), and leaves singular values just above the cutoff. Its
coefficients are then determined only to about eps times the square of
that system's condition number: the port's and the JAX coefficients part by
up to 1.6e-3 of their scale (both sides' inputs differ in the last bit of
the bases and the products). There the knots keep the f32 bar and the
coefficients are held to what least squares determines, the residual of
the fit: the port's within 1e-6 of the JAX residual, relative (8.5e-8 at
worst over 20 seeds)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kagnn_tpu.graphs import single_graph as jax_single_graph
from kagnn_tpu.kan import adapt as jadapt
from kagnn_tpu.kan import bspline as jbs
from kagnn_tpu.models import NodeClassifier as JaxNodeClassifier
from kagnn_tpu_torch.data import community_node_graph
from kagnn_tpu_torch.graphs import single_graph
from kagnn_tpu_torch.kan import adapt as tadapt
from kagnn_tpu_torch.kan import bspline as tbs
from kagnn_tpu_torch.kan.layers import KAN
from kagnn_tpu_torch.models import NodeClassifier
from kagnn_tpu_torch.utils.port import from_jax_variables, to_jax_variables

torch.set_num_threads(1)
VAL = dict(rtol=1e-4, atol=1e-5)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32).copy())


def _layer(rng, d, o, grid, k):
    knots = np.asarray(jbs.make_grid(d, grid, k))
    w = (rng.normal(size=(o, d, grid + k)) * 0.3).astype(np.float32)
    scaler = rng.normal(size=(o, d)).astype(np.float32)
    return knots, w, scaler


def samples(rng, kind, n, d):
    if kind == "spread":
        return rng.normal(size=(n, d)).astype(np.float32)
    if kind == "tied":
        # a few distinct values per feature: most knot intervals hold none
        return rng.choice([-0.7, 0.1, 0.4], size=(n, d)).astype(np.float32)
    # a sampled batch: most rows are zero pad rows
    x = np.zeros((n, d), np.float32)
    x[: n // 8] = rng.normal(size=(n // 8, d))
    return x


def _both_updates(rng, kind, k, grid, n=300, d=6, o=5):
    x = samples(rng, kind, n, d)
    knots, w, scaler = _layer(rng, d, o, grid, k)
    want = jbs.update_grid(jnp.asarray(x), jnp.asarray(knots), jnp.asarray(w),
                           jnp.asarray(scaler), grid_size=grid, spline_order=k)
    got = tbs.update_grid(_t(x), _t(knots), _t(w), _t(scaler), grid_size=grid,
                          spline_order=k)
    return (x, knots, w, scaler), got, [np.asarray(a) for a in want]


@pytest.mark.parametrize("kind,shape", [
    (kind, shape) for kind in ("spread", "tied")
    for shape in ((3, 4), (1, 1), (4, 8), (2, 16))]
    + [("pad_rows", (3, 4)), ("pad_rows", (1, 1))])
def test_update_grid_matches_jax(kind, shape, rng):
    k, grid = shape
    _, got, want = _both_updates(rng, kind, k, grid)
    for a, b in zip(got, want):
        assert torch.isfinite(a).all()
        np.testing.assert_allclose(a.numpy(), b, **VAL)


@pytest.mark.parametrize("seed", [0, 1, 4])
@pytest.mark.parametrize("shape", [(4, 8), (2, 8), (4, 16)])
def test_update_grid_on_pad_rows_fits_as_well_as_jax(shape, seed):
    """The ill-conditioned case of the module docstring: the knots at the
    f32 bar, the refit's residual (in f64, against the old weights'
    function on the samples) within 1e-6 of the JAX fit's, relative."""
    k, grid = shape
    (x, knots, w, scaler), got, want = _both_updates(
        np.random.default_rng(seed), "pad_rows", k, grid)
    np.testing.assert_allclose(got[0].numpy(), want[0], **VAL)
    x64 = _t(x).double()
    old = torch.einsum("bic,oic->bio", tbs.b_splines(x64, _t(knots).double(), k),
                       (_t(w) * _t(scaler)[..., None]).double())
    basis = tbs.b_splines(x64, got[0].double(), k)

    def residual(weight):
        return (torch.einsum("bic,oic->bio", basis, weight.double()) - old).norm().item()

    mine, theirs = residual(got[1]), residual(_t(want[1]))
    assert abs(mine - theirs) <= 1e-6 * theirs, (mine, theirs)


@pytest.mark.parametrize("solve", ["lstsq", "lstsq_svd"])
def test_rank_deficient_solve_is_jax_min_norm(solve, rng):
    """The CPU's gelsd and the card's SVD formula (run here on the CPU)
    against jnp.linalg.lstsq on systems with zero and repeated columns."""
    A = rng.normal(size=(4, 200, 7)).astype(np.float32)
    A[:, :, 2] = 0.0  # a basis with no sample
    A[:, :, 5] = A[:, :, 4]  # two bases that cannot be told apart
    A[1, 150:] = 0.0  # zero pad rows
    B = rng.normal(size=(4, 200, 3)).astype(np.float32)
    want = np.stack([np.asarray(jnp.linalg.lstsq(jnp.asarray(a), jnp.asarray(b))[0])
                     for a, b in zip(A, B)])
    got = getattr(tbs, solve)(_t(A), _t(B)).numpy()
    np.testing.assert_allclose(got, want, **VAL)
    assert np.abs(got[:, 2]).max() <= VAL["atol"]
    np.testing.assert_allclose(got[:, 4], got[:, 5], **VAL)


def test_update_kan_stack_matches_jax(rng):
    x = rng.normal(size=(200, 5)).astype(np.float32)
    from kagnn_tpu.kan.layers import KAN as JaxKAN

    jm = JaxKAN([5, 7, 3], grid_size=4, spline_order=3)
    v = jm.init(jax.random.key(0), jnp.asarray(x))
    new = jadapt.update_kan_stack(jm, v, jnp.asarray(x))
    tm = KAN([5, 7, 3], grid_size=4, spline_order=3, device="cpu")
    sd = {}
    for coll in ("params", "buffers"):
        for lname, leaves in v[coll].items():
            for leaf, val in leaves.items():
                sd[f"layers.{lname.split('_')[1]}.{leaf}"] = _t(val)
    tm.load_state_dict(sd)
    tadapt.update_kan_stack(tm, _t(x))
    for coll in ("params", "buffers"):
        for lname, leaves in new[coll].items():
            for leaf, val in leaves.items():
                got = tm.state_dict()[f"layers.{lname.split('_')[1]}.{leaf}"]
                np.testing.assert_allclose(got.numpy(), np.asarray(val), **VAL)


def _jax_order(model, g) -> list[tuple]:
    """The JAX adaptation's layer order: `_kan_in_paths` of the model's
    sown intermediates (shapes only: traced, not run)."""
    def sown():
        v = model.init(jax.random.key(0), g)
        return model.apply(v, g, train=False, mutable=["intermediates"])[1]

    return jadapt._kan_in_paths(jax.eval_shape(sown)["intermediates"])


@pytest.mark.parametrize("conv", ["gin", "gcn", "gat"])
def test_adaptation_order_is_jax_string_order(conv):
    """11 convs: the JAX order sorts "KAN_10" before "KAN_2" (and every
    net before "head"), not the order of execution; the port maps its
    module names through the weight carrier's naming to the same paths."""
    d = community_node_graph(n_nodes=24, n_classes=2, num_features=3, seed=1)
    kw = dict(conv_type=conv, architecture="kan", mp_layers=11, num_features=3,
              hidden_channels=2, num_classes=2, heads=1, hidden_layers=2)
    gj = jax_single_graph(d["senders"], d["receivers"], nodes=d["nodes"])
    want = _jax_order(JaxNodeClassifier(**kw), gj)
    got = [p for p, _, _ in tadapt.kan_layers_in_jax_order(
        NodeClassifier(device="cpu", **kw))]
    assert got == want
    assert got.index(want[-1]) == len(got) - 1 and want[-1] == ("head",)
    if conv == "gin":
        assert want.index(("KAN_10", "layers_0")) < want.index(("KAN_2", "layers_0"))


def _adapt_both(kw, dtype):
    d = community_node_graph(n_nodes=150, n_classes=3, num_features=6, seed=4)
    gj = jax_single_graph(d["senders"], d["receivers"], nodes=d["nodes"])
    gt = single_graph(d["senders"], d["receivers"], nodes=d["nodes"], device="cpu")
    jm = JaxNodeClassifier(compute_dtype=dtype and jnp.bfloat16, **kw)
    v = jax.tree.map(np.asarray, jm.init(jax.random.key(0), gj))
    # the stored running statistics of a trained model (eval reads them)
    r = np.random.default_rng(2)
    v["batch_stats"] = jax.tree.map(
        lambda a: (r.random(a.shape) + 0.5).astype(np.float32), v["batch_stats"])
    new = jadapt.adapt_model_grids(jm.clone(fused=False), v, gj, train=False)
    tm = NodeClassifier(compute_dtype=dtype, fused=True, device="cpu", **kw)
    tm.load_state_dict(from_jax_variables(v))
    tm.train()
    names = tadapt.adapt_model_grids(tm, gt)
    assert tm.training and all(getattr(m, "fused", True) for m in tm.modules())
    return new, tm, names


def test_adapt_model_grids_matches_jax():
    """A 2-conv gin/kan NodeClassifier with a KAN head, f32: the layers in
    the JAX order, every adapted knot grid and spline weight (and every
    other leaf unchanged) at the f32 bar. The port model is fused; the
    adaptation runs it unfused in eval mode, as the JAX one applies an
    unfused clone with train=False, and restores both."""
    kw = dict(conv_type="gin", architecture="kan", mp_layers=2, num_features=6,
              hidden_channels=8, num_classes=3, skip=True, hidden_layers=2)
    new, tm, names = _adapt_both(kw, None)
    assert names == ["convs.0.update.layers.0", "convs.0.update.layers.1",
                     "convs.1.update.layers.0", "convs.1.update.layers.1", "head"]
    mine = to_jax_variables(tm.state_dict())
    for path, want in jax.tree_util.tree_leaves_with_path(new):
        key = [p.key for p in path]
        got = mine
        for k in key:
            got = got[k]
        np.testing.assert_allclose(got, np.asarray(want), err_msg=str(key), **VAL)


def test_adapt_bf16_refits_on_the_f32_cast_input():
    """Under bf16 the hooked input is the bf16 activation cast to f32: the
    first layer in the JAX order (a GCN conv's transform, whose input is the
    exactly cast node features) adapts to the JAX grid and weight at the
    f32 bar."""
    kw = dict(conv_type="gcn", architecture="kan", mp_layers=2, num_features=6,
              hidden_channels=8, num_classes=3, skip=False)
    new, tm, names = _adapt_both(kw, torch.bfloat16)
    assert names[0] == "convs.0.transform"
    want = new["buffers"]["GCNConv_0"]["KANLinear_0"]["grid"]
    np.testing.assert_allclose(tm.convs[0].transform.grid.numpy(), want, **VAL)
    want = new["params"]["GCNConv_0"]["KANLinear_0"]["spline_weight"]
    np.testing.assert_allclose(tm.convs[0].transform.spline_weight.detach().numpy(),
                               want, **VAL)
