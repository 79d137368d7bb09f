"""The whole slice, per node path: the port's NodeClassifier train step
against the JAX one on weights carried by `utils/port.py`, for gin/kan,
gcn/kan, gcn/fastkan, gin/fastkan, gat/kan and gat/fastkan (3 conv layers,
width 16, 2 GAT heads of 16, 120 nodes).

  * f32: the port's kernel path (fused=True, plain kernel versions on the
    CPU) and its unfused path against JAX fused=False under
    use_pallas_spmm(False): logits, every parameter gradient, BatchNorm
    running statistics after one step and a 3-step Adam loss trajectory.
    Values rtol 1e-4 / atol 1e-5, gradients rtol 1e-3 / atol 1e-5: the
    same f32 arithmetic in another summation order.
  * bf16: the port's kernel path against JAX fused=True with its Pallas
    kernels in interpret mode (use_pallas_spmm(True, interpret=True), which
    the GCN aggregate needs to take its kernel off the TPU). Both round at
    the same points, but XLA may keep f32 between fused elementwise ops
    where PyTorch rounds each op to bf16, so one-ulp differences enter
    every layer and pass through three convs, three BatchNorms and the
    head. Logits and the loss trajectory are held to 4 bf16 ulps (4 * 2^-8)
    of their scale; gradients, which sum those differences over every node,
    to 8. A bias that feeds a BatchNorm directly (a GCN conv's, or the last
    layer's of a FastKAN update net) has a gradient that is zero in exact
    arithmetic, so on both sides it is rounding noise: it is held, on each
    side, to 8 bf16 ulps of the largest gradient of its conv. On the GAT
    paths the gradients of att_src, att_dst and of the transform's bias
    (FastKAN) also nearly cancel: the softmax weights of a row sum to one
    and the BatchNorm removes each column's mean, so they are 1-4 % of
    their conv's largest gradient, and each bf16 model carries 5-45 ulps of
    their own scale of rounding noise against the f32 gradient (measured on
    this graph); they are held to 8 bf16 ulps of their conv's largest
    gradient (0.6 at most measured). gin/kan's
    bf16 step is tests/test_torch_node_step.py::test_bf16_step_matches_jax_fused.
    gin/fastkan is held against the JAX model as it is: its GINConv sums z
    in the compute dtype for a FastKAN net, and so does the port's.
  * the launches of one train step, counted through the plain versions the
    kernel wrappers run on the CPU.
"""
import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from kagnn_tpu.graphs import single_graph as jax_single_graph
from kagnn_tpu.kan import layers as jkan_layers
from kagnn_tpu.models import NodeClassifier as JaxNodeClassifier
from kagnn_tpu.ops import segment as jsegment
from kagnn_tpu.train import losses as jlosses
from kagnn_tpu_torch.data import community_node_graph
from kagnn_tpu_torch.graphs import single_graph
from kagnn_tpu_torch.kan import FastKANLayer
from kagnn_tpu_torch.kernels import bspline_fused as bf
from kagnn_tpu_torch.kernels import fastkan_layer as fk
from kagnn_tpu_torch.kernels import gat_bwd as gbw
from kagnn_tpu_torch.kernels import gat_fused as gfu
from kagnn_tpu_torch.kernels import gcn_agg as ga
from kagnn_tpu_torch.kernels import gin_fastkan as gfk
from kagnn_tpu_torch.kernels import gin_fused as gf
from kagnn_tpu_torch.kernels import spmm
from kagnn_tpu_torch.models import NodeClassifier
from kagnn_tpu_torch.train import make_node_steps, masked_softmax_cross_entropy
from kagnn_tpu_torch.utils.port import from_jax_variables, to_jax_variables

torch.set_num_threads(1)

KW = dict(mp_layers=3, num_features=8, hidden_channels=16, num_classes=3,
          grid_size=4, spline_order=3, skip=False, heads=2)
PATHS = [("gin", "kan"), ("gcn", "kan"), ("gcn", "fastkan"),
         ("gin", "fastkan"), ("gat", "kan"), ("gat", "fastkan")]
IDS = [f"{c}-{a}" for c, a in PATHS]
VAL = dict(rtol=1e-4, atol=1e-5)
GRAD = dict(rtol=1e-3, atol=1e-5)
BF16_ULP = 2.0 ** -8
# biases that feed a BatchNorm directly (KW's update nets have 2 layers)
BN_FED_BIAS = re.compile(r"convs\.\d+\.(bias|update\.layers\.1\.base_linear\.bias)")
# GAT gradients that sum nearly cancelling logit sensitivities
GAT_LOGIT_GRAD = re.compile(r"convs\.\d+\.(att_src|att_dst|transform\.base_linear\.bias)")
# plain versions the kernel wrappers run on the CPU, one per CUDA kernel
PLAIN = {"gin_fused": (gf, "gin_kan_fwd_plain"),
         "bspline_fwd": (bf, "kan_linear_fwd_plain"),
         "bspline_bwd": (bf, "kan_linear_bwd_plain"),
         "spmm": (spmm, "sorted_segment_sum_plain"),
         "gcn_agg": (ga, "gcn_agg_plain"),
         "fastkan_fwd": (fk, "fastkan_layer_fwd_plain"),
         "fastkan_bwd": (fk, "fastkan_layer_bwd_plain"),
         "gin_fastkan": (gfk, "gin_fastkan_fwd_plain"),
         "gat_fwd": (gfu, "gat_fwd_plain"),
         "gat_dadst": (gbw, "gat_dadst_plain"),
         "gat_sender": (gbw, "gat_sender_plain")}
PER_STEP = {
    ("gin", "kan"): {"gin_fused": 3, "bspline_fwd": 4, "bspline_bwd": 7,
                     "spmm": 2},
    ("gcn", "kan"): {"gcn_agg": 3, "bspline_fwd": 4, "bspline_bwd": 4,
                     "spmm": 3},
    ("gcn", "fastkan"): {"gcn_agg": 3, "fastkan_fwd": 4, "fastkan_bwd": 4,
                         "spmm": 3},
    ("gin", "fastkan"): {"spmm": 5, "fastkan_fwd": 7, "fastkan_bwd": 7},
    ("gat", "kan"): {"bspline_fwd": 4, "bspline_bwd": 4, "gat_fwd": 3,
                     "gat_dadst": 3, "gat_sender": 3},
    ("gat", "fastkan"): {"fastkan_fwd": 4, "fastkan_bwd": 4, "gat_fwd": 3,
                         "gat_dadst": 3, "gat_sender": 3},
}


@pytest.fixture(scope="module")
def graph():
    d = community_node_graph(n_nodes=120, n_classes=3, num_features=8, seed=3)
    gj = jax_single_graph(d["senders"], d["receivers"], nodes=d["nodes"],
                          y=d["y"])
    gt = single_graph(d["senders"], d["receivers"], nodes=d["nodes"],
                      y=d["y"], device="cpu")
    mask = np.zeros(gt.n_node_pad, bool)
    mask[:d["n_node"]] = d["masks"]["train"]
    return gj, gt, mask


@pytest.fixture(scope="module")
def variables(graph):
    """The JAX model's initial variables per path, made once."""
    gj, _, _ = graph
    made = {}

    def get(path):
        if path not in made:
            kw = dict(KW, conv_type=path[0], architecture=path[1])
            with jsegment.use_pallas_spmm(False):
                v = JaxNodeClassifier(fused=False, **kw).init(
                    jax.random.key(0), gj)
            made[path] = kw, jax.tree.map(np.asarray, v)
        return made[path]
    return get


def _jax_run(model, v, gj, mask, n):
    """n steps of the JAX train step (masked CE, optax Adam(1e-3)) with one
    jitted value-and-grad of the model's train-mode loss: the loss of each
    step, and the logits, parameter gradients and new batch stats of the
    first. The train-mode loss reads no running statistic, so carrying the
    initial batch stats through the steps changes nothing."""
    def loss_fn(params):
        out, mut = model.apply(dict(v, params=params), gj, train=True,
                               rngs={"dropout": jax.random.key(0)},
                               mutable=["batch_stats"])
        return jlosses.masked_softmax_cross_entropy(out, gj.y, mask), (out, mut)

    grad_fn = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    tx = optax.adam(1e-3)
    params = v["params"]
    opt = tx.init(params)
    losses = []
    for i in range(n):
        (loss, (out, mut)), grads = grad_fn(params)
        if i == 0:
            first = np.asarray(out), grads, mut["batch_stats"]
        losses.append(float(loss))
        updates, opt = tx.update(grads, opt, params)
        params = optax.apply_updates(params, updates)
    return (losses, *first)


def _port(kw, v, fused, cd=None):
    m = NodeClassifier(fused=fused, compute_dtype=cd, device="cpu", **kw)
    m.load_state_dict(from_jax_variables(v))
    return m


def _port_losses(m, gt, mask, n):
    step, _ = make_node_steps(m, torch.optim.Adam(m.parameters(), lr=1e-3))
    return [float(step(gt, torch.from_numpy(mask))) for _ in range(n)]


@pytest.mark.parametrize("path", PATHS, ids=IDS)
def test_weight_carrier_round_trip(variables, path):
    """JAX tree -> state_dict -> JAX tree is the identity, and the port's
    own state_dict maps onto the JAX tree's structure."""
    kw, v = variables(path)
    back = to_jax_variables(from_jax_variables(v))
    assert jax.tree.structure(back) == jax.tree.structure(v)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(v)):
        np.testing.assert_array_equal(a, b)
    own = to_jax_variables(NodeClassifier(device="cpu", **kw).state_dict())
    assert jax.tree.structure(own) == jax.tree.structure(v)
    for a, b in zip(jax.tree.leaves(own), jax.tree.leaves(v)):
        assert a.shape == b.shape


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("path", PATHS, ids=IDS)
def test_f32_step_matches_jax_unfused(graph, variables, path, fused):
    gj, gt, mask = graph
    kw, v = variables(path)
    jm = JaxNodeClassifier(fused=False, **kw)
    with jsegment.use_pallas_spmm(False):
        traj_j, oj, gj_grads, bs = _jax_run(jm, v, gj, mask, 3)
    m = _port(kw, v, fused)
    m.train()
    logits = m(gt)
    loss = masked_softmax_cross_entropy(logits, gt.y, torch.from_numpy(mask))
    loss.backward()
    nm = gt.node_mask.numpy()
    np.testing.assert_allclose(logits.detach().numpy()[nm], oj[nm], **VAL)
    np.testing.assert_allclose(loss.item(), traj_j[0], **VAL)
    want = from_jax_variables({"params": gj_grads})
    for name, p in m.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   err_msg=name, **GRAD)
    want_bs = from_jax_variables({"batch_stats": bs})
    for name, b in m.named_buffers():
        if name in want_bs:
            np.testing.assert_allclose(b.numpy(), want_bs[name].numpy(),
                                       err_msg=name, **VAL)
    np.testing.assert_allclose(_port_losses(_port(kw, v, fused), gt, mask, 3),
                               traj_j, **VAL)


def conv_scale(grads, name):
    """The largest gradient of the conv that parameter `name` belongs to."""
    conv = name.split(".")[1]
    return max(np.abs(a).max() for k, a in grads.items()
               if k.startswith(f"convs.{conv}."))


@pytest.mark.parametrize("path", PATHS[1:], ids=IDS[1:])
def test_bf16_step_matches_jax_fused(graph, variables, path):
    gj, gt, mask = graph
    kw, v = variables(path)
    jm = JaxNodeClassifier(fused=True, compute_dtype=jnp.bfloat16, **kw)
    with jsegment.use_pallas_spmm(True, interpret=True):
        traj_j, oj, gj_grads, _ = _jax_run(jm, v, gj, mask, 3)
    m = _port(kw, v, True, torch.bfloat16)
    m.train()
    logits = m(gt)
    masked_softmax_cross_entropy(logits, gt.y, torch.from_numpy(mask)).backward()
    ot = logits.detach().numpy()
    nm = gt.node_mask.numpy()
    assert ot.dtype == np.float32
    assert np.abs(ot[nm] - oj[nm]).max() <= 4 * BF16_ULP * np.abs(oj[nm]).max()
    want = {k: t.numpy() for k, t in
            from_jax_variables({"params": gj_grads}).items()}
    for name, p in m.named_parameters():
        assert p.dtype == torch.float32  # f32 master weights
        g, w = p.grad.numpy(), want[name]
        if BN_FED_BIAS.fullmatch(name):
            assert max(np.abs(g).max(), np.abs(w).max()) <= \
                8 * BF16_ULP * conv_scale(want, name), name
            continue
        err = np.abs(g - w).max()
        if path[0] == "gat" and GAT_LOGIT_GRAD.fullmatch(name):
            assert err <= 8 * BF16_ULP * conv_scale(want, name), (name, err)
            continue
        assert err <= 8 * BF16_ULP * np.abs(w).max(), (name, err)
    traj_t = _port_losses(_port(kw, v, True, torch.bfloat16), gt, mask, 3)
    np.testing.assert_allclose(traj_t, traj_j, rtol=4 * BF16_ULP)


@pytest.mark.parametrize("path", PATHS, ids=IDS)
def test_step_calls_each_kernel_per_step(graph, variables, path, monkeypatch):
    """The launches of one bf16 train step per kernel (PERF.md gives the
    reasons): every conv's aggregate kernel once, the layer forward for
    each update layer not fused with the aggregate, each GCN or GAT
    transform and the head, the layer backward for those and for each
    GIN+KAN residual, the segment sum once per conv that needs A^T·dz (GIN:
    not conv 0, whose input needs no gradient; GCN: every conv, since dhs
    feeds the transform's weights) and once more per GIN+FastKAN forward,
    and both GAT backward kernels at every conv (h needs a gradient for the
    transform's weights)."""
    gj, gt, mask = graph
    kw, v = variables(path)
    calls = dict.fromkeys(PLAIN, 0)

    def counting(key, fn):
        def f(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return f

    for key, (mod, name) in PLAIN.items():
        monkeypatch.setattr(mod, name, counting(key, getattr(mod, name)))
    m = _port(kw, v, True, torch.bfloat16)
    step, _ = make_node_steps(m, torch.optim.Adam(m.parameters(), lr=1e-3))
    step(gt, torch.from_numpy(mask))
    assert {k: n for k, n in calls.items() if n} == PER_STEP[path]


def test_gin_fastkan_bf16_rounds_z_where_the_jax_model_does(graph, variables,
                                                            monkeypatch):
    """The JAX GINConv hands the aggregation to a KAN update net only
    (kagnn_tpu/nn/convs.py GINConv): with a FastKAN net it sums the
    neighbours in the compute dtype, rounds z to bf16 and runs the layer on
    it, never pallas/gin_fastkan.py. The port does the same: no
    FastKANLayer gets the graph on either side, the port's GIN+FastKAN
    kernel is not called, and its bf16 train-mode logits are within 4 bf16
    ulps of the logits' scale of the JAX model's."""
    gj, gt, mask = graph
    kw, v = variables(("gin", "fastkan"))
    jax_calls, port_calls = [], []
    orig = jkan_layers.FastKANLayer.__call__

    def spy(self, x, *a, gin_graph=None, **k):
        jax_calls.append(gin_graph is not None)
        return orig(self, x, *a, gin_graph=gin_graph, **k)

    monkeypatch.setattr(jkan_layers.FastKANLayer, "__call__", spy)
    with jsegment.use_pallas_spmm(True, interpret=True):
        jb, _ = JaxNodeClassifier(fused=True, compute_dtype=jnp.bfloat16,
                                  **kw).apply(
            v, gj, train=True, rngs={"dropout": jax.random.key(0)},
            mutable=["batch_stats"])
    assert jax_calls and not any(jax_calls)
    plain = gfk.gin_fastkan_fwd_plain
    monkeypatch.setattr(gfk, "gin_fastkan_fwd_plain",
                        lambda *a: port_calls.append("kernel") or plain(*a))
    m = _port(kw, v, True, torch.bfloat16)
    m.train()
    for layer in m.modules():
        if isinstance(layer, FastKANLayer):
            layer.register_forward_pre_hook(
                lambda mod, args, kwargs: port_calls.append(
                    kwargs.get("gin_graph")), with_kwargs=True)
    with torch.no_grad():
        tb = m(gt).numpy()
    assert port_calls == [None] * 7  # 6 update layers and the head
    nm = gt.node_mask.numpy()
    jb = np.asarray(jb)
    assert np.abs(tb[nm] - jb[nm]).max() <= 4 * BF16_ULP * np.abs(jb[nm]).max()
