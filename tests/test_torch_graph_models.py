"""The graph tasks' modules and whole models against the JAX package, in
f32, on weights carried by `utils/port.py`:

  * `segment_sum`, `segment_mean` and `sender_gather` (fused and plain),
    `GINEConv` with its gradients to x and e, both pools (on a batch whose
    last graph ends one row before the pad), the encoders (the column clamp
    on one-column input, the index clip), `masked_nll` and `masked_l1`;
  * all 9 `GraphClassifier` paths (gin, gcn, gat x mlp, kan, fastkan) and
    all 6 `GraphRegressor` paths (gin, gcn x mlp, kan, fastkan; OGB
    encoders, and gin/kan with the linear ones): the port's kernel path
    (fused=True, plain kernel versions on the CPU) and its unfused path
    against JAX fused=False under use_pallas_spmm(False): outputs, every
    parameter gradient, BatchNorm running statistics after one step and a
    3-step Adam loss trajectory. Values rtol 1e-4 / atol 1e-5, gradients
    rtol 1e-3 / atol 1e-5: the same f32 arithmetic in another summation
    order;
  * the carrier round-trips both trees.
The bf16 steps, the launches and the epoch loop are in
tests/test_torch_graph_steps.py."""
import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from kagnn_tpu.graphs.batch import PadSpec as JaxPadSpec
from kagnn_tpu.graphs.batch import batch_graphs as jax_batch_graphs
from kagnn_tpu.models.graph import GraphClassifier as JaxGraphClassifier
from kagnn_tpu.models.regression import GraphRegressor as JaxGraphRegressor
from kagnn_tpu.nn import convs as jconvs
from kagnn_tpu.nn import encoders as jencoders
from kagnn_tpu.ops import segment as jsegment
from kagnn_tpu.train import losses as jlosses
from kagnn_tpu_torch.data import random_molecule_graphs
from kagnn_tpu_torch.graphs import PadSpec, batch_graphs, pad_spec_for
from kagnn_tpu_torch.models import GraphClassifier, GraphRegressor
from kagnn_tpu_torch.nn import (AtomEncoder, BondEncoder, GINEConv,
                                global_add_pool, global_mean_pool)
from kagnn_tpu_torch.ops import segment
from kagnn_tpu_torch.train import (make_graph_cls_steps, make_graph_reg_steps,
                                   masked_l1, masked_nll)
from kagnn_tpu_torch.utils.port import from_jax_variables, to_jax_variables

torch.set_num_threads(1)

VAL = dict(rtol=1e-4, atol=1e-5)
GRAD = dict(rtol=1e-3, atol=1e-5)
CLS_PATHS = [(c, a) for c in ("gin", "gcn", "gat")
             for a in ("mlp", "kan", "fastkan")]
REG_PATHS = [(c, a, True) for c in ("gin", "gcn")
             for a in ("mlp", "kan", "fastkan")] + [("gin", "kan", False)]
CLS_KW = dict(gnn_layers=2, num_features=6, hidden_dim=8, num_classes=2,
              hidden_layers=2, grid_size=3, spline_order=2, heads=2)
REG_KW = dict(gnn_layers=2, num_node_features=1, num_edge_features=1,
              hidden_dim=8, hidden_layers=2, grid_size=4, spline_order=3)


def cls_ids(paths):
    return [f"{c}-{a}" for c, a in paths]


def reg_ids(paths):
    return [f"{c}-{a}" + ("" if ogb else "-linear") for c, a, ogb in paths]


def molecules(target, n=8, seed=11):
    """n molecules of 4-10 atoms; classification nodes one-hot over 6 atom
    types, regression nodes and bonds the categorical columns."""
    gs = random_molecule_graphs(n, 4, 10, num_atom_types=6, seed=seed,
                                target=target)
    if target == "classification":
        for g in gs:
            g["nodes"] = np.eye(6, dtype=np.float32)[g["nodes"][:, 0]]
    return gs


def batches(target, n=8, seed=11):
    """(JAX batch, port batch) of n molecules, padded by pad_spec_for."""
    gs = molecules(target, n, seed)
    spec = pad_spec_for(gs, n)
    jspec = JaxPadSpec(spec.n_node, spec.n_edge, spec.n_graph)
    return jax_batch_graphs(gs, jspec), batch_graphs(gs, spec, device="cpu")


@pytest.fixture(scope="module")
def cls_batch():
    return batches("classification")


@pytest.fixture(scope="module")
def reg_batch():
    return batches("regression")


def jax_model(path, fused=False, cd=None):
    if len(path) == 2:
        return JaxGraphClassifier(path[0], path[1], fused=fused,
                                  compute_dtype=cd, **CLS_KW)
    return JaxGraphRegressor(path[0], path[1], ogb_encoders=path[2],
                             fused=fused, compute_dtype=cd, **REG_KW)


def port_model(path, v, fused, cd=None):
    if len(path) == 2:
        m = GraphClassifier(path[0], path[1], fused=fused, compute_dtype=cd,
                            device="cpu", **CLS_KW)
    else:
        m = GraphRegressor(path[0], path[1], ogb_encoders=path[2], fused=fused,
                           compute_dtype=cd, device="cpu", **REG_KW)
    m.load_state_dict(from_jax_variables(v))
    return m


def jax_loss(path, out, b):
    if len(path) == 2:
        return jlosses.masked_nll(out, b.y.astype(jnp.int32), b.graph_mask)
    return jlosses.masked_l1(out, b.y, b.graph_mask)


def port_steps(path, m):
    make = make_graph_cls_steps if len(path) == 2 else make_graph_reg_steps
    return make(m, torch.optim.Adam(m.parameters(), lr=1e-3))


def init_variables(path, bj):
    with jsegment.use_pallas_spmm(False):
        v = jax_model(path).init(jax.random.key(0), bj)
    return jax.tree.map(np.asarray, v)


def jax_run(model, path, v, bj, n):
    """n steps of the JAX train step (the task's loss, optax Adam(1e-3))
    with one jitted value-and-grad of the train-mode loss: the loss of each
    step, and the output, parameter gradients and new batch stats of the
    first. The train-mode loss reads no running statistic, so carrying the
    initial batch stats through the steps changes nothing."""
    def loss_fn(params):
        out, mut = model.apply(dict(v, params=params), bj, train=True,
                               rngs={"dropout": jax.random.key(0)},
                               mutable=["batch_stats"])
        return jax_loss(path, out, bj), (out, mut)

    grad_fn = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    tx = optax.adam(1e-3)
    params = v["params"]
    opt = tx.init(params)
    losses = []
    for i in range(n):
        (loss, (out, mut)), grads = grad_fn(params)
        if i == 0:
            first = np.asarray(out), grads, mut.get("batch_stats", {})
        losses.append(float(loss))
        updates, opt = tx.update(grads, opt, params)
        params = optax.apply_updates(params, updates)
    return (losses, *first)


_F32_RUNS = {}


def jax_f32(path, bj):
    """The JAX fused=False run of a path, made once per module."""
    if path not in _F32_RUNS:
        v = init_variables(path, bj)
        with jsegment.use_pallas_spmm(False):
            _F32_RUNS[path] = v, jax_run(jax_model(path), path, v, bj, 3)
    return _F32_RUNS[path]


def check_f32_path(path, bj, gt, fused):
    v, (traj, oj, grads, bs) = jax_f32(path, bj)
    m = port_model(path, v, fused)
    m.train()
    out = m(gt)
    loss = (masked_nll(out, gt.y, gt.graph_mask) if len(path) == 2
            else masked_l1(out, gt.y, gt.graph_mask))
    loss.backward()
    gm = gt.graph_mask.numpy()
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.detach().numpy()[gm], oj[gm], **VAL)
    np.testing.assert_allclose(loss.item(), traj[0], **VAL)
    want = from_jax_variables({"params": grads})
    assert set(want) == {n for n, _ in m.named_parameters()}
    for name, p in m.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   err_msg=name, **GRAD)
    want_bs = from_jax_variables({"batch_stats": bs}) if bs else {}
    for name, b in m.named_buffers():
        if name in want_bs:
            np.testing.assert_allclose(b.numpy(), want_bs[name].numpy(),
                                       err_msg=name, **VAL)
    assert len(want_bs) == sum(n.endswith(("running_mean", "running_var"))
                               for n, _ in m.named_buffers())
    step, _ = port_steps(path, port_model(path, v, fused))
    np.testing.assert_allclose([float(step(gt)) for _ in range(3)], traj, **VAL)


@pytest.mark.parametrize("fused", [True, False], ids=["kernels", "plain"])
@pytest.mark.parametrize("path", CLS_PATHS, ids=cls_ids(CLS_PATHS))
def test_classifier_f32_step_matches_jax(cls_batch, path, fused):
    check_f32_path(path, *cls_batch, fused)


@pytest.mark.parametrize("fused", [True, False], ids=["kernels", "plain"])
@pytest.mark.parametrize("path", REG_PATHS, ids=reg_ids(REG_PATHS))
def test_regressor_f32_step_matches_jax(reg_batch, path, fused):
    check_f32_path(path, *reg_batch, fused)


@pytest.mark.parametrize("path", CLS_PATHS + REG_PATHS,
                         ids=cls_ids(CLS_PATHS) + reg_ids(REG_PATHS))
def test_weight_carrier_round_trip(cls_batch, reg_batch, path):
    """JAX tree -> state_dict -> JAX tree is the identity, and the port
    model's own state_dict maps onto the JAX tree's structure."""
    bj = (cls_batch if len(path) == 2 else reg_batch)[0]
    v = init_variables(path, bj)
    back = to_jax_variables(from_jax_variables(v))
    assert jax.tree.structure(back) == jax.tree.structure(v)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(v)):
        np.testing.assert_array_equal(a, b)
    if len(path) == 2:
        own = GraphClassifier(path[0], path[1], device="cpu", **CLS_KW)
    else:
        own = GraphRegressor(path[0], path[1], ogb_encoders=path[2],
                             device="cpu", **REG_KW)
    mine = to_jax_variables(own.state_dict())
    assert jax.tree.structure(mine) == jax.tree.structure(v)
    for a, b in zip(jax.tree.leaves(mine), jax.tree.leaves(v)):
        assert a.shape == b.shape


def filled_batches():
    """(JAX, port) batches of 5 molecules whose last graph ends exactly
    one row before the pad (n_node = n_node_pad - 1), 2 empty pad graphs."""
    gs = molecules("regression", 5, seed=2)
    n = sum(g["n_node"] for g in gs)
    e = sum(len(g["senders"]) for g in gs) + 128
    return (jax_batch_graphs(gs, JaxPadSpec(n + 1, e, 8)),
            batch_graphs(gs, PadSpec(n + 1, e, 8), device="cpu"))


@pytest.mark.parametrize("fused", [True, False], ids=["kernels", "plain"])
def test_segment_ops_match_jax(fused):
    """segment_sum and segment_mean over node_graph (graph_row_ptr) and
    over the receivers (recv_row_ptr), sender_gather and its gradient,
    against the JAX ops with garbage in the pad rows."""
    bj, gt = filled_batches()
    rng = np.random.default_rng(0)
    x = rng.normal(size=(gt.n_node_pad, 5)).astype(np.float32)
    msgs = rng.normal(size=(gt.n_edge_pad, 5)).astype(np.float32)
    xt, mt = torch.from_numpy(x), torch.from_numpy(msgs)
    G, N = gt.n_graph_pad, gt.n_node_pad
    with jsegment.use_pallas_spmm(False):
        cases = [
            (segment.segment_sum(xt, gt.node_graph, G, gt.graph_row_ptr, fused),
             jsegment.segment_sum(x, bj.node_graph, G, True)),
            (segment.segment_mean(xt, gt.node_graph, G, gt.node_mask,
                                  gt.graph_row_ptr, fused),
             jsegment.segment_mean(x, bj.node_graph, G, True, bj.node_mask)),
            (segment.segment_mean(xt, gt.node_graph, G, None,
                                  gt.graph_row_ptr, fused),
             jsegment.segment_mean(x, bj.node_graph, G, True)),
            (segment.segment_sum(mt, gt.receivers, N, gt.recv_row_ptr, fused),
             jsegment.segment_sum(msgs, bj.receivers, N, True)),
        ]
        w = rng.normal(size=(gt.n_edge_pad, 5)).astype(np.float32)
        want_dx = jax.grad(lambda a: (jsegment.sender_gather(a, bj) * w).sum())(x)
    for got, want in cases:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **VAL)
    xg = xt.clone().requires_grad_(True)
    out = segment.sender_gather(xg, gt, fused=fused)
    np.testing.assert_array_equal(out.detach().numpy(), x[gt.senders.numpy()])
    (out * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(xg.grad.numpy(), np.asarray(want_dx), **GRAD)


class _JaxIdentity(fnn.Module):
    @fnn.compact
    def __call__(self, x, mask=None, train=False):
        return x


class _Identity(nn.Module):
    def forward(self, x, mask=None, train=False):
        return x


@pytest.mark.parametrize("fused", [True, False], ids=["kernels", "plain"])
def test_gine_conv_matches_jax(fused):
    """GINEConv with an identity update net: (1+eps)x + Σ relu(x_j + e_ij)
    over valid edges, and its gradients to x and e."""
    bj, gt = filled_batches()
    rng = np.random.default_rng(1)
    x = rng.normal(size=(gt.n_node_pad, 6)).astype(np.float32)
    e = rng.normal(size=(gt.n_edge_pad, 6)).astype(np.float32)
    w = rng.normal(size=(gt.n_node_pad, 6)).astype(np.float32)
    conv = jconvs.GINEConv(_JaxIdentity(), eps=0.25)

    def f(a, b):
        return (conv.apply({}, bj, a, b) * w).sum()

    with jsegment.use_pallas_spmm(False):
        want = conv.apply({}, bj, x, e)
        want_dx, want_de = jax.grad(f, argnums=(0, 1))(x, e)
    xt = torch.from_numpy(x).requires_grad_(True)
    et = torch.from_numpy(e).requires_grad_(True)
    out = GINEConv(_Identity(), eps=0.25, fused=fused)(gt, xt, et)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), **VAL)
    (out * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_dx), **GRAD)
    np.testing.assert_allclose(et.grad.numpy(), np.asarray(want_de), **GRAD)
    assert not et.grad.numpy()[~gt.edge_mask.numpy()].any()


@pytest.mark.parametrize("fused", [True, False], ids=["kernels", "plain"])
def test_pools_match_jax(fused):
    """Both pools with garbage in the pad row: add masks x first, mean
    masks the count; empty pad graphs pool to 0; gradients too."""
    bj, gt = filled_batches()
    rng = np.random.default_rng(2)
    x = rng.normal(size=(gt.n_node_pad, 7)).astype(np.float32)
    w = rng.normal(size=(gt.n_graph_pad, 7)).astype(np.float32)
    for ours, theirs in ((global_add_pool, jconvs.global_add_pool),
                         (global_mean_pool, jconvs.global_mean_pool)):
        with jsegment.use_pallas_spmm(False):
            want = theirs(bj, x)
            want_dx = jax.grad(lambda a: (theirs(bj, a) * w).sum())(x)
        xt = torch.from_numpy(x).requires_grad_(True)
        out = ours(gt, xt, fused=fused)
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), **VAL)
        assert not out.detach().numpy()[gt.n_graph:].any()
        (out * torch.from_numpy(w)).sum().backward()
        np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_dx), **GRAD)


@pytest.mark.parametrize("cols", [1, 3, 9])
def test_encoders_match_jax(cols):
    """AtomEncoder and BondEncoder on tables carried from JAX: with one
    column every table reads column 0 (jnp clamps the static column index),
    with 3 the tables past column 2 read column 2; indices past a table are
    clipped to its last row, negative ones to row 0."""
    rng = np.random.default_rng(cols)
    x = rng.integers(-3, 130, size=(40, cols)).astype(np.int32)
    for ours, theirs in ((AtomEncoder, jencoders.AtomEncoder),
                         (BondEncoder, jencoders.BondEncoder)):
        module, xj = theirs(8), jnp.asarray(x)
        v = jax.tree.map(np.asarray, module.init(jax.random.key(cols), xj))
        enc = ours(8, device="cpu")
        tables = v["params"]["CategoricalSumEncoder_0"]
        enc.load_state_dict({f"emb.{k}": torch.tensor(tables[f"emb_{k}"])
                             for k in range(len(tables))})
        got = enc(torch.from_numpy(x))
        assert got.dtype == torch.float32 and got.shape == (40, 8)
        np.testing.assert_allclose(got.detach().numpy(),
                                   np.asarray(module.apply(v, xj)), **VAL)
        last = cols - 1
        want = sum(enc.emb[i].detach().numpy()[np.clip(x[:, min(i, last)], 0, d - 1)]
                   for i, d in enumerate(enc.feature_dims))
        np.testing.assert_allclose(got.detach().numpy(), want, **VAL)


def test_losses_match_jax():
    rng = np.random.default_rng(3)
    logits = rng.normal(size=(9, 4)).astype(np.float32)
    lp = np.asarray(jax.nn.log_softmax(logits))
    labels = rng.integers(0, 4, 9).astype(np.int32)
    mask = rng.random(9) < 0.6
    pred = rng.normal(size=(9, 1)).astype(np.float32)
    target = rng.normal(size=9).astype(np.float32)
    t = torch.from_numpy
    np.testing.assert_allclose(masked_nll(t(lp), t(labels), t(mask)).item(),
                               float(jlosses.masked_nll(lp, labels, mask)), **VAL)
    np.testing.assert_allclose(masked_l1(t(pred), t(target), t(mask)).item(),
                               float(jlosses.masked_l1(pred, target, mask)), **VAL)
    none = np.zeros(9, bool)
    assert masked_nll(t(lp), t(labels), t(none)).item() == 0.0
