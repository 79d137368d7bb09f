"""The whole slice, per node path: the port's NodeClassifier train step
against the JAX one on weights carried by `utils/port.py`, for gin/kan,
gcn/kan, gcn/fastkan and gin/fastkan (3 conv layers, width 16, 120 nodes).

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
    side, to 8 bf16 ulps of the largest gradient of its conv. gin/kan's
    bf16 step is tests/test_torch_node_step.py::test_bf16_step_matches_jax_fused.
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
from kagnn_tpu.train.loops import TrainState
from kagnn_tpu.train.loops import make_node_steps as jax_make_node_steps
from kagnn_tpu_torch.data import community_node_graph
from kagnn_tpu_torch.graphs import single_graph
from kagnn_tpu_torch.kernels import bspline_fused as bf
from kagnn_tpu_torch.kernels import fastkan_layer as fk
from kagnn_tpu_torch.kernels import gcn_agg as ga
from kagnn_tpu_torch.kernels import gin_fastkan as gfk
from kagnn_tpu_torch.kernels import gin_fused as gf
from kagnn_tpu_torch.kernels import spmm
from kagnn_tpu_torch.models import NodeClassifier
from kagnn_tpu_torch.train import make_node_steps, masked_softmax_cross_entropy
from kagnn_tpu_torch.utils.port import from_jax_variables, to_jax_variables

torch.set_num_threads(1)

KW = dict(mp_layers=3, num_features=8, hidden_channels=16, num_classes=3,
          grid_size=4, spline_order=3, skip=False)
PATHS = [("gin", "kan"), ("gcn", "kan"), ("gcn", "fastkan"),
         ("gin", "fastkan")]
IDS = [f"{c}-{a}" for c, a in PATHS]
VAL = dict(rtol=1e-4, atol=1e-5)
GRAD = dict(rtol=1e-3, atol=1e-5)
BF16_ULP = 2.0 ** -8
# biases that feed a BatchNorm directly (KW's update nets have 2 layers)
BN_FED_BIAS = re.compile(r"convs\.\d+\.(bias|update\.layers\.1\.base_linear\.bias)")
# plain versions the kernel wrappers run on the CPU, one per CUDA kernel
PLAIN = {"gin_fused": (gf, "gin_kan_fwd_plain"),
         "bspline_fwd": (bf, "kan_linear_fwd_plain"),
         "bspline_bwd": (bf, "kan_linear_bwd_plain"),
         "spmm": (spmm, "sorted_segment_sum_plain"),
         "gcn_agg": (ga, "gcn_agg_plain"),
         "fastkan_fwd": (fk, "fastkan_layer_fwd_plain"),
         "fastkan_bwd": (fk, "fastkan_layer_bwd_plain"),
         "gin_fastkan": (gfk, "gin_fastkan_fwd_plain")}
PER_STEP = {
    ("gin", "kan"): {"gin_fused": 3, "bspline_fwd": 4, "bspline_bwd": 7,
                     "spmm": 2},
    ("gcn", "kan"): {"gcn_agg": 3, "bspline_fwd": 4, "bspline_bwd": 4,
                     "spmm": 3},
    ("gcn", "fastkan"): {"gcn_agg": 3, "fastkan_fwd": 4, "fastkan_bwd": 4,
                         "spmm": 3},
    ("gin", "fastkan"): {"gin_fastkan": 3, "fastkan_fwd": 4,
                         "fastkan_bwd": 7, "spmm": 2},
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


def _jax_step(model, v, gj, mask):
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
    state = TrainState(params=v["params"], buffers=v.get("buffers", {}),
                       batch_stats=v["batch_stats"],
                       opt_state=tx.init(v["params"]),
                       step=jnp.zeros((), jnp.int32))
    step, _ = jax_make_node_steps(model, tx)
    out = []
    for _ in range(n):
        state, loss = step(state, gj, jnp.asarray(mask), jax.random.key(0))
        out.append(float(loss))
    return out


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
        lj, oj, gj_grads, bs = _jax_step(jm, v, gj, mask)
        traj_j = _jax_losses(jm, v, gj, mask, 3)
    m = _port(kw, v, fused)
    m.train()
    logits = m(gt)
    loss = masked_softmax_cross_entropy(logits, gt.y, torch.from_numpy(mask))
    loss.backward()
    nm = gt.node_mask.numpy()
    np.testing.assert_allclose(logits.detach().numpy()[nm], oj[nm], **VAL)
    np.testing.assert_allclose(loss.item(), lj, **VAL)
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


@pytest.mark.parametrize("path", PATHS[1:], ids=IDS[1:])
def test_bf16_step_matches_jax_fused(graph, variables, path, monkeypatch):
    gj, gt, mask = graph
    kw, v = variables(path)
    # the JAX GINConv hands the aggregation to a KAN update net only; route
    # a FastKAN net through its fusion point too, as the port does (see
    # test_gin_fastkan_bf16_rounds_z_where_the_jax_model_does_not)
    monkeypatch.setattr(jkan_layers, "KAN", (jkan_layers.KAN, jkan_layers.FastKAN))
    jm = JaxNodeClassifier(fused=True, compute_dtype=jnp.bfloat16, **kw)
    with jsegment.use_pallas_spmm(True, interpret=True):
        _, oj, gj_grads, _ = _jax_step(jm, v, gj, mask)
        traj_j = _jax_losses(jm, v, gj, mask, 3)
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
            conv = name.split(".")[1]
            scale = max(np.abs(a).max() for k, a in want.items()
                        if k.startswith(f"convs.{conv}."))
            assert max(np.abs(g).max(), np.abs(w).max()) <= \
                8 * BF16_ULP * scale, name
            continue
        err = np.abs(g - w).max()
        assert err <= 8 * BF16_ULP * np.abs(w).max(), (name, err)
    traj_t = _port_losses(_port(kw, v, True, torch.bfloat16), gt, mask, 3)
    np.testing.assert_allclose(traj_t, traj_j, rtol=4 * BF16_ULP)


@pytest.mark.parametrize("path", PATHS, ids=IDS)
def test_step_calls_each_kernel_per_step(graph, variables, path, monkeypatch):
    """The launches of one bf16 train step per kernel (PERF.md gives the
    reasons): every conv's forward kernel once, the layer forward for each
    second update layer (GIN) and the head, the layer backward for those and
    for each GIN residual or GCN transform, and the segment sum once per
    conv that needs A^T·dz (GIN: not conv 0, whose input needs no gradient;
    GCN: every conv, since dhs feeds the transform's weights)."""
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


def test_gin_fastkan_bf16_rounds_z_where_the_jax_model_does_not(graph,
                                                                variables):
    """The JAX GINConv hands the aggregation to a KAN update net only
    (kagnn_tpu/nn/convs.py GINConv); with a FastKAN net it sums the
    neighbours in the compute dtype and rounds z to bf16 before the layer,
    so the JAX gin/fastkan model never reaches pallas/gin_fastkan.py. The
    port routes FastKAN through the layer's fusion point (the f32 z of the
    GIN+FastKAN kernel), as it routes KAN. In f32 the two orders agree
    (test_f32_step_matches_jax_unfused); under bf16 the port's train-mode
    logits are no further from the f32 logits than the JAX bf16 model's,
    give or take 4 bf16 ulps of their scale, and no further than 32 bf16
    ulps of that scale from the JAX bf16 model's own logits (24.3 measured
    on this graph and these weights: the JAX model is 20.2 ulps from the f32
    logits, the port 4.2). Which routing the port keeps is open in ROADMAP
    Queue 3."""
    gj, gt, mask = graph
    kw, v = variables(("gin", "fastkan"))
    calls = []
    orig = jkan_layers.FastKANLayer.__call__

    def spy(self, x, *a, gin_graph=None, **k):
        calls.append(gin_graph is not None)
        return orig(self, x, *a, gin_graph=gin_graph, **k)

    def jax_logits(fused, cd):
        ctx = (jsegment.use_pallas_spmm(True, interpret=True) if fused
               else jsegment.use_pallas_spmm(False))
        with ctx:
            out, _ = JaxNodeClassifier(fused=fused, compute_dtype=cd, **kw).apply(
                v, gj, train=True, rngs={"dropout": jax.random.key(0)},
                mutable=["batch_stats"])
        return np.asarray(out)

    ref = jax_logits(False, None)
    jkan_layers.FastKANLayer.__call__ = spy
    try:
        jb = jax_logits(True, jnp.bfloat16)
    finally:
        jkan_layers.FastKANLayer.__call__ = orig
    assert calls and not any(calls)  # no FastKANLayer got the graph
    m = _port(kw, v, True, torch.bfloat16)
    m.train()
    with torch.no_grad():
        tb = m(gt).numpy()
    nm = gt.node_mask.numpy()
    ulp = BF16_ULP * np.abs(ref[nm]).max()
    assert np.abs(tb[nm] - ref[nm]).max() <= \
        np.abs(jb[nm] - ref[nm]).max() + 4 * ulp
    assert np.abs(tb[nm] - jb[nm]).max() <= 32 * ulp
