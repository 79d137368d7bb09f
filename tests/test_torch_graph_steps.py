"""The graph tasks' train steps in bf16, their launches and the epoch
loop, against the JAX package:

  * bf16 (over f32 master weights): the port's kernel path (fused=True,
    the plain kernel versions on the CPU) against JAX fused=True with its
    Pallas kernels in interpret mode (use_pallas_spmm(True,
    interpret=True)), for all 9 `GraphClassifier` and 6 `GraphRegressor`
    paths: outputs and the first loss within 4 bf16 ulps (4 * 2^-8) of
    their scale, and a 3-step Adam loss trajectory within 4 ulps of each
    loss. Both sides round at the same points, but XLA may keep f32 between
    fused elementwise ops where PyTorch rounds each op to bf16, and the
    JAX gather's transpose in GINE scatters bf16 cotangents where the port
    sums them in f32 and rounds once. A graph-level loss over 8 molecules
    leaves the bf16 gradients of these small models noisier than the node
    paths': the JAX bf16 model's own gradients lie up to 23 bf16 ulps of
    their scale from its f32 model's on the classifier batch, and up to
    about 200 on the regression batch, where a residual of the L1 loss
    that changes sign between the two models moves the gradient by a
    graph's share. So each gradient passes two bars
    (`selfcheck.bf16_grad_ratios`): within 8 bf16 ulps of its scale of the
    JAX bf16 gradient, plus the JAX bf16 gradient's distance from the JAX
    f32 one capped at 14 ulps; and no farther from the JAX f32 gradient than
    the JAX bf16 gradient is, plus 8 ulps. The worst ratio of each bar is
    printed. A bias that feeds a BatchNorm directly (the last layer's of
    a GIN FastKAN update net) has a gradient that is zero in exact
    arithmetic, so on both sides it is rounding noise; the GAT paths'
    att_src and att_dst gradients sum nearly cancelling logit
    sensitivities (the softmax weights of a row sum to one). As in
    tests/test_torch_node_paths.py, their scale is the largest gradient of
    their conv;
  * the launches of one bf16 step of G (graph classification, gin/kan,
    3 convs) and R (graph regression, gin/kan, 4 GINE convs) at a small
    width, counted through the plain versions the kernel wrappers run on
    the CPU;
  * `train_graph_epochs` over 3 epochs of batches from `batch_loader`
    against the JAX epoch loop in f32: best validation loss, test metric and
    epochs run (values rtol 1e-4 / atol 1e-5)."""
import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from kagnn_tpu.graphs.batch import PadSpec as JaxPadSpec
from kagnn_tpu.ops import segment as jsegment
from kagnn_tpu.train import loops as jloops
from kagnn_tpu.train.experiments import batch_loader as jax_batch_loader
from kagnn_tpu_torch.graphs import pad_spec_for
from kagnn_tpu_torch.kernels import bspline_fused as bf
from kagnn_tpu_torch.kernels import gin_fused as gf
from kagnn_tpu_torch.kernels import spmm
from kagnn_tpu_torch.kernels.selfcheck import bf16_grad_ratios
from kagnn_tpu_torch.train import masked_l1, masked_nll, train_graph_epochs
from kagnn_tpu_torch.train.experiments import batch_loader
from kagnn_tpu_torch.utils.port import from_jax_variables
from test_torch_graph_models import (CLS_KW, CLS_PATHS, REG_KW, VAL, cls_ids,
                                     init_variables, jax_f32, jax_model,
                                     jax_run, molecules, port_model,
                                     port_steps, reg_ids)
from test_torch_graph_models import batches as make_batches
from test_torch_node_paths import PLAIN

torch.set_num_threads(1)

BF16_ULP = 2.0 ** -8
REG_PATHS = [(c, a, True) for c in ("gin", "gcn")
             for a in ("mlp", "kan", "fastkan")]
# biases that feed a BatchNorm directly: the last layer's of a GIN FastKAN
# update net (the external BatchNorm follows it)
BN_FED_BIAS = re.compile(r"convs\.\d+\.update\.layers\.1\.base_linear\.bias")
# GAT gradients that sum nearly cancelling logit sensitivities
GAT_LOGIT_GRAD = re.compile(r"convs\.\d+\.(att_src|att_dst)")
# launches of one bf16 train step, reckoned from the code: G's three GIN
# convs fuse their aggregate into the update net's first KANLinear; the
# second layer and the head's two run the layer forward; every layer runs
# the layer backward; the segment sum computes A^T dz at convs 1 and 2 (conv
# 0's input needs no gradient) and the pool. R's four GINE convs each run
# the segment sum for the aggregate and for the gradient to x (the
# encoder's output needs one), the pool once more; 8 update layers and 2
# head layers forward and backward
PER_STEP = {
    "G": {"gin_fused": 3, "bspline_fwd": 5, "bspline_bwd": 8, "spmm": 3},
    "R": {"bspline_fwd": 10, "bspline_bwd": 10, "spmm": 9},
}


@pytest.fixture(scope="module")
def cls_batch():
    return make_batches("classification")


@pytest.fixture(scope="module")
def reg_batch():
    return make_batches("regression")


def conv_scale(grads, name):
    """The largest gradient of the conv that parameter `name` belongs to."""
    conv = name.split(".")[1]
    return max(np.abs(a).max() for k, a in grads.items()
               if k.startswith(f"convs.{conv}."))


def check_bf16_path(path, bj, gt):
    v = init_variables(path, bj)
    with jsegment.use_pallas_spmm(True, interpret=True):
        traj, oj, grads, _ = jax_run(jax_model(path, True, jnp.bfloat16),
                                     path, v, bj, 3)
    m = port_model(path, v, True, torch.bfloat16)
    m.train()
    out = m(gt)
    gm = gt.graph_mask.numpy()
    loss = (masked_nll(out, gt.y, gt.graph_mask) if len(path) == 2
            else masked_l1(out, gt.y, gt.graph_mask))
    loss.backward()
    ot, oj = out.detach().numpy()[gm], oj[gm]
    assert ot.dtype == np.float32
    assert np.abs(ot - oj).max() <= 4 * BF16_ULP * np.abs(oj).max()
    assert abs(loss.item() - traj[0]) <= 4 * BF16_ULP * abs(traj[0])
    want = {k: t.numpy() for k, t in
            from_jax_variables({"params": grads}).items()}
    f32 = {k: t.numpy() for k, t in
           from_jax_variables({"params": jax_f32(path, bj)[1][2]}).items()}
    worst = [(0.0, ""), (0.0, "")]
    for name, p in m.named_parameters():
        assert p.dtype == torch.float32  # f32 master weights
        w = want[name]
        noise = BN_FED_BIAS.fullmatch(name) or GAT_LOGIT_GRAD.fullmatch(name)
        scale = conv_scale(want, name) if noise else np.abs(w).max()
        ratios = bf16_grad_ratios(p.grad.numpy(), w, f32[name], scale)
        worst = [max(wr, (r, name)) for wr, r in zip(worst, ratios)]
    print(f"{path}: worst bf16 gradient err/bar against JAX bf16 "
          f"{worst[0][0]:.3f} ({worst[0][1]}), against JAX f32 "
          f"{worst[1][0]:.3f} ({worst[1][1]})")
    assert worst[0][0] <= 1 and worst[1][0] <= 1, worst
    step, _ = port_steps(path, port_model(path, v, True, torch.bfloat16))
    np.testing.assert_allclose([float(step(gt)) for _ in range(3)], traj,
                               rtol=4 * BF16_ULP)


@pytest.mark.parametrize("path", CLS_PATHS, ids=cls_ids(CLS_PATHS))
def test_classifier_bf16_step_matches_jax_fused(cls_batch, path):
    check_bf16_path(path, *cls_batch)


@pytest.mark.parametrize("path", REG_PATHS, ids=reg_ids(REG_PATHS))
def test_regressor_bf16_step_matches_jax_fused(reg_batch, path):
    check_bf16_path(path, *reg_batch)


@pytest.mark.parametrize("name", ["G", "R"])
def test_step_calls_each_kernel_per_step(cls_batch, reg_batch, name,
                                         monkeypatch):
    """G and R at the full paths' depth (3 GIN convs; 4 GINE convs, update
    nets and heads of 2 layers) and a small width."""
    calls = dict.fromkeys(PLAIN, 0)

    def counting(key, fn):
        def f(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return f

    for key, (mod, fn) in PLAIN.items():
        monkeypatch.setattr(mod, fn, counting(key, getattr(mod, fn)))
    if name == "G":
        path, kw, gt = ("gin", "kan"), dict(CLS_KW, gnn_layers=3), cls_batch[1]
        from kagnn_tpu_torch.models import GraphClassifier as Model
    else:
        path, kw, gt = ("gin", "kan", True), dict(REG_KW, gnn_layers=4), reg_batch[1]
        from kagnn_tpu_torch.models import GraphRegressor as Model
    m = Model(path[0], path[1], fused=True, compute_dtype=torch.bfloat16,
              device="cpu", **kw)
    step, _ = port_steps(path, m)
    assert np.isfinite(float(step(gt)))
    assert {k: n for k, n in calls.items() if n} == PER_STEP[name]
    # the CPU wrappers count no launch of their own
    assert (spmm.sorted_segment_sum.launches, bf.kan_linear_fwd.launches,
            gf.gin_kan_fwd.launches) == (0, 0, 0)


def _jax_state(v, tx):
    return jloops.TrainState(params=v["params"], buffers=v.get("buffers", {}),
                             batch_stats=v.get("batch_stats", {}),
                             opt_state=tx.init(v["params"]),
                             step=jnp.zeros((), jnp.int32))


@pytest.mark.parametrize("path", [("gin", "kan"), ("gcn", "fastkan", True)],
                         ids=["classification-gin-kan", "regression-gcn-fastkan"])
def test_train_graph_epochs_matches_jax(path, cls_batch, reg_batch):
    """Train, validation and test loaders of 8, 4 and 4 molecules, batches
    of 3 (the last batch of each pass short), train shuffled by seed 5;
    patience 2."""
    cls = len(path) == 2
    gs = molecules("classification" if cls else "regression", 16, seed=21)
    spec = pad_spec_for(gs, 3)
    jspec = JaxPadSpec(spec.n_node, spec.n_edge, spec.n_graph)
    parts = (gs[:8], gs[8:12], gs[12:])
    ours = [batch_loader(p, spec, 3, shuffle=i == 0, seed=5, device="cpu")
            for i, p in enumerate(parts)]
    theirs = [jax_batch_loader(p, jspec, 3, shuffle=i == 0, seed=5,
                               native=False) for i, p in enumerate(parts)]
    v = init_variables(path, (cls_batch if cls else reg_batch)[0])
    tx = optax.adam(1e-3)
    jmodel = jax_model(path)
    make = jloops.make_graph_cls_steps if cls else jloops.make_graph_reg_steps
    with jsegment.use_pallas_spmm(False):
        jstep, jeval = make(jmodel, tx)
        want = jloops.train_graph_epochs(
            _jax_state(v, tx), jstep, jeval, theirs[0], theirs[1], 3, 2,
            jax.random.key(0), test_batches=theirs[2], classification=cls)
    m = port_model(path, v, True)
    step, evaluate = port_steps(path, m)
    got = train_graph_epochs(m, step, evaluate, ours[0], ours[1], 3, 2,
                             test_batches=ours[2], classification=cls)
    assert got["epochs_run"] == want["epochs_run"]
    np.testing.assert_allclose(got["best_val_loss"], want["best_val_loss"], **VAL)
    np.testing.assert_allclose(got["test_metric"], want["test_metric"], **VAL)
    # the best state is a copy of the model's state_dict
    assert got["state"].keys() == m.state_dict().keys()
    assert all(t.data_ptr() != m.state_dict()[k].data_ptr()
               for k, t in got["state"].items())
