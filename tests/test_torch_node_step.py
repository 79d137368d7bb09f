"""The whole slice: the port's gin/kan NodeClassifier train step against the
JAX one on carried-over weights (3 conv layers, width 16, 120 nodes).

  * f32: the port's kernel path (fused=True, plain kernel versions on the
    CPU) and its unfused path against JAX fused=False under
    use_pallas_spmm(False): logits, every parameter gradient, BatchNorm
    running statistics after one step and a 3-step Adam loss trajectory.
    Values rtol 1e-4 / atol 1e-5, gradients rtol 1e-3 / atol 1e-5: the
    same f32 arithmetic in another summation order.
  * bf16: the port's kernel path against JAX fused=True (Pallas kernels in
    interpret mode). Both round at the same points, but XLA may keep f32
    between fused elementwise ops where PyTorch rounds each op to bf16, so
    one-ulp differences enter every layer and pass through three convs,
    three BatchNorms and the head. Logits and the loss trajectory are held
    to 4 bf16 ulps (4 * 2^-8) of their scale; gradients, which sum those
    differences over every node, to 8.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from kagnn_tpu.graphs import single_graph as jax_single_graph
from kagnn_tpu.models import NodeClassifier as JaxNodeClassifier
from kagnn_tpu.ops import segment as jsegment
from kagnn_tpu.train import losses as jlosses
from kagnn_tpu.train.loops import TrainState
from kagnn_tpu.train.loops import make_node_steps as jax_make_node_steps
from kagnn_tpu_torch.data import community_node_graph
from kagnn_tpu_torch.graphs import single_graph
from kagnn_tpu_torch.kernels import bspline_fused as bf
from kagnn_tpu_torch.kernels import gin_fused as gf
from kagnn_tpu_torch.kernels import spmm
from kagnn_tpu_torch.models import NodeClassifier
from kagnn_tpu_torch.train import (EarlyStopper, make_node_steps,
                                   masked_accuracy,
                                   masked_softmax_cross_entropy)
from kagnn_tpu_torch.utils.port import from_jax_variables, to_jax_variables

torch.set_num_threads(1)

KW = dict(conv_type="gin", architecture="kan", mp_layers=3, num_features=8,
          hidden_channels=16, num_classes=3, grid_size=4, spline_order=3,
          skip=False)
VAL = dict(rtol=1e-4, atol=1e-5)
GRAD = dict(rtol=1e-3, atol=1e-5)
BF16_ULP = 2.0 ** -8


@pytest.fixture(scope="module")
def setup():
    d = community_node_graph(n_nodes=120, n_classes=3, num_features=8, seed=3)
    gj = jax_single_graph(d["senders"], d["receivers"], nodes=d["nodes"],
                          y=d["y"])
    gt = single_graph(d["senders"], d["receivers"], nodes=d["nodes"],
                      y=d["y"], device="cpu")
    mask = np.zeros(gt.n_node_pad, bool)
    mask[:d["n_node"]] = d["masks"]["train"]
    with jsegment.use_pallas_spmm(False):
        v = JaxNodeClassifier(fused=False, **KW).init(jax.random.key(0), gj)
    return gj, gt, mask, jax.tree.map(np.asarray, v)


def _jax_step(model, v, gj, mask):
    """Logits, parameter gradients and new batch stats of one train-mode
    forward/backward, as the JAX train step computes them."""
    def loss_fn(params):
        out, mut = model.apply(dict(v, params=params), gj, train=True,
                               rngs={"dropout": jax.random.key(0)},
                               mutable=["batch_stats"])
        return jlosses.masked_softmax_cross_entropy(out, gj.y, mask), (out, mut)

    (loss, (out, mut)), grads = jax.value_and_grad(loss_fn, has_aux=True)(
        v["params"])
    return float(loss), np.asarray(out), grads, mut["batch_stats"]


def _jax_losses(model, v, gj, mask, n):
    tx = optax.adam(1e-3)
    state = TrainState(params=v["params"], buffers=v["buffers"],
                       batch_stats=v["batch_stats"],
                       opt_state=tx.init(v["params"]),
                       step=jnp.zeros((), jnp.int32))
    step, _ = jax_make_node_steps(model, tx)
    out = []
    for _ in range(n):
        state, loss = step(state, gj, jnp.asarray(mask), jax.random.key(0))
        out.append(float(loss))
    return out


def _port(v, fused, cd=None):
    m = NodeClassifier(fused=fused, compute_dtype=cd, device="cpu", **KW)
    m.load_state_dict(from_jax_variables(v))
    return m


def _port_step(m, gt, mask):
    m.train()
    logits = m(gt)
    loss = masked_softmax_cross_entropy(logits, gt.y, torch.from_numpy(mask))
    loss.backward()
    return loss.item(), logits.detach().numpy()


def _port_losses(m, gt, mask, n):
    step, _ = make_node_steps(m, torch.optim.Adam(m.parameters(), lr=1e-3))
    return [float(step(gt, torch.from_numpy(mask))) for _ in range(n)]


def test_weight_carrier_round_trip(setup):
    _, _, _, v = setup
    back = to_jax_variables(from_jax_variables(v))
    assert jax.tree.structure(back) == jax.tree.structure(v)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(v)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("fused", [True, False])
def test_f32_step_matches_jax_unfused(setup, fused):
    gj, gt, mask, v = setup
    jm = JaxNodeClassifier(fused=False, **KW)
    with jsegment.use_pallas_spmm(False):
        lj, oj, gj_grads, bs = _jax_step(jm, v, gj, mask)
        traj_j = _jax_losses(jm, v, gj, mask, 3)
    m = _port(v, fused)
    lt, ot = _port_step(m, gt, mask)
    nm = gt.node_mask.numpy()
    np.testing.assert_allclose(ot[nm], oj[nm], **VAL)
    np.testing.assert_allclose(lt, lj, **VAL)
    want = from_jax_variables({"params": gj_grads})
    for name, p in m.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   err_msg=name, **GRAD)
    want_bs = from_jax_variables({"batch_stats": bs})
    for name, b in m.named_buffers():
        if name in want_bs:
            np.testing.assert_allclose(b.numpy(), want_bs[name].numpy(),
                                       err_msg=name, **VAL)
    np.testing.assert_allclose(_port_losses(_port(v, fused), gt, mask, 3),
                               traj_j, **VAL)


def test_bf16_step_matches_jax_fused(setup):
    gj, gt, mask, v = setup
    jm = JaxNodeClassifier(fused=True, compute_dtype=jnp.bfloat16, **KW)
    lj, oj, gj_grads, _ = _jax_step(jm, v, gj, mask)
    traj_j = _jax_losses(jm, v, gj, mask, 3)
    m = _port(v, True, torch.bfloat16)
    lt, ot = _port_step(m, gt, mask)
    nm = gt.node_mask.numpy()
    assert ot.dtype == np.float32
    assert np.abs(ot[nm] - oj[nm]).max() <= 4 * BF16_ULP * np.abs(oj[nm]).max()
    want = from_jax_variables({"params": gj_grads})
    for name, p in m.named_parameters():
        assert p.dtype == torch.float32  # f32 master weights
        w = want[name].numpy()
        err = np.abs(p.grad.numpy() - w).max()
        assert err <= 8 * BF16_ULP * np.abs(w).max(), (name, err)
    traj_t = _port_losses(_port(v, True, torch.bfloat16), gt, mask, 3)
    np.testing.assert_allclose(traj_t, traj_j, rtol=4 * BF16_ULP)


def test_main_path_calls_each_kernel_per_step(setup, monkeypatch):
    """One train step goes through the fused GIN kernel once per conv, the
    KANLinear forward kernel for each second update layer and the head, its
    backward 7 times (3 of them on the GIN residual z) and the segment sum
    twice (conv 0's input needs no gradient). Counted through the plain
    versions the wrappers run on the CPU."""
    gj, gt, mask, v = setup
    calls = {"gin": 0, "fwd": 0, "bwd": 0, "spmm": 0}

    def counting(key, fn):
        def f(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return f

    monkeypatch.setattr(gf, "gin_kan_fwd_plain",
                        counting("gin", gf.gin_kan_fwd_plain))
    monkeypatch.setattr(bf, "kan_linear_fwd_plain",
                        counting("fwd", bf.kan_linear_fwd_plain))
    monkeypatch.setattr(bf, "kan_linear_bwd_plain",
                        counting("bwd", bf.kan_linear_bwd_plain))
    monkeypatch.setattr(spmm, "sorted_segment_sum_plain",
                        counting("spmm", spmm.sorted_segment_sum_plain))
    m = _port(v, True, torch.bfloat16)
    step, _ = make_node_steps(m, torch.optim.Adam(m.parameters(), lr=1e-3))
    step(gt, torch.from_numpy(mask))
    assert calls == {"gin": 3, "fwd": 4, "bwd": 7, "spmm": 2}


def test_evaluate_uses_running_stats_and_accuracy(setup):
    gj, gt, mask, v = setup
    with jsegment.use_pallas_spmm(False):
        oj = np.asarray(JaxNodeClassifier(fused=False, **KW).apply(v, gj))
    m = _port(v, True)
    _, evaluate = make_node_steps(m, torch.optim.Adam(m.parameters(), 1e-3))
    ot = evaluate(gt)
    nm = gt.node_mask.numpy()
    np.testing.assert_allclose(ot.numpy()[nm], oj[nm], **VAL)
    tm = torch.from_numpy(mask)
    np.testing.assert_allclose(
        masked_accuracy(ot, gt.y, tm).item(),
        float(jlosses.masked_accuracy(jnp.asarray(oj), gj.y, mask)), **VAL)


def test_skip_connections_match_jax(setup):
    """skip=True concatenates [x0, h1, h2, h3] before the head (the JAX
    default), eval-mode forward on carried-over weights."""
    gj, gt, _, _ = setup
    kw = dict(KW, skip=True)
    with jsegment.use_pallas_spmm(False):
        jm = JaxNodeClassifier(fused=False, **kw)
        v = jax.tree.map(np.asarray, jm.init(jax.random.key(1), gj))
        oj = np.asarray(jm.apply(v, gj))
    m = NodeClassifier(fused=True, device="cpu", **kw)
    m.load_state_dict(from_jax_variables(v))
    m.eval()
    nm = gt.node_mask.numpy()
    np.testing.assert_allclose(m(gt).detach().numpy()[nm], oj[nm], **VAL)


def test_dropout_draws_from_the_model_generator(setup):
    """Dropout is applied in train mode only, from a generator seeded by
    the model's seed: the same seed gives the same mask."""
    _, gt, _, v = setup
    outs = []
    for seed in (5, 5, 6):
        m = NodeClassifier(**dict(KW, dropout=0.5), seed=seed, device="cpu")
        m.load_state_dict(from_jax_variables(v))
        outs.append(m(gt).detach())
    assert torch.equal(outs[0], outs[1]) and not torch.equal(outs[0], outs[2])
    m = NodeClassifier(**dict(KW, dropout=0.5), device="cpu")
    m.load_state_dict(from_jax_variables(v))
    ref = _port(v, False)
    m.eval()
    ref.eval()
    torch.testing.assert_close(m(gt), ref(gt), rtol=0, atol=0)


def test_early_stopper():
    s = EarlyStopper(patience=2, min_delta=0.1)
    assert s.early_stop(1.0) == (True, False)
    assert s.early_stop(1.05) == (False, False)  # within min_delta
    assert s.early_stop(1.2) == (False, False)
    assert s.early_stop(1.3) == (False, True)


@pytest.mark.parametrize("conv,arch", [("gine", "kan"), ("gin", "linear")])
def test_unknown_conv_or_architecture_raises(conv, arch):
    with pytest.raises(ValueError, match="unknown conv_type/architecture"):
        NodeClassifier(**dict(KW, conv_type=conv, architecture=arch),
                       device="cpu")
