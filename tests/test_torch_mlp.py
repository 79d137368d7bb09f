"""The node MLP baselines (the reference's GNN_Nodes): the port's
`nn/mlp.py` (`TorchLinear`, `MLP`), `nn/convs.py::dense_transform` and the
gin/mlp, gcn/mlp and gat/mlp paths of `NodeClassifier` against the JAX
package on weights carried by `utils/port.py` (3 conv layers, width 16, 2
GAT heads of 16, 120 nodes).

  * `TorchLinear` and `MLP` alone: values and gradients against the JAX
    modules in f32 (rtol 1e-4 / atol 1e-5 values, 1e-3 / 1e-5 gradients),
    a bf16 input against the JAX promotion (the same f32 product: the
    input's cast is exact), the `hidden_layers=1` quirk (Linear -> ReLU) and
    `batch_norm=True` (batch statistics in train mode, running ones in
    eval mode, and the updated running statistics).
  * the three paths as `tests/test_torch_node_paths.py` holds the KAN ones:
    f32 against JAX fused=False under use_pallas_spmm(False) (values rtol
    1e-4 / atol 1e-5, gradients rtol 1e-3 / atol 1e-5, a 3-step Adam
    trajectory), bf16 against JAX fused=True with its Pallas kernels in
    interpret mode (logits and trajectory 4 bf16 ulps of their scale,
    gradients 8; the BatchNorm-fed biases and GAT's logit gradients as
    there). Under bf16 both models are f32 from the first dense product on
    (the f32 weights promote), which a test checks layer by layer against
    the JAX model's intermediates; so the bf16 ratios read far below 1.
  * the launches of one bf16 train step, counted through the plain
    versions the kernel wrappers run on the CPU, and the carrier's round
    trip.
"""
import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from kagnn_tpu.graphs import single_graph as jax_single_graph
from kagnn_tpu.models import NodeClassifier as JaxNodeClassifier
from kagnn_tpu.nn.mlp import MLP as JaxMLP
from kagnn_tpu.nn.mlp import TorchLinear as JaxTorchLinear
from kagnn_tpu.ops import segment as jsegment
from kagnn_tpu.train import losses as jlosses
from kagnn_tpu_torch.data import community_node_graph
from kagnn_tpu_torch.graphs import single_graph
from kagnn_tpu_torch.kernels import gat_bwd as gbw
from kagnn_tpu_torch.kernels import gat_fused as gfu
from kagnn_tpu_torch.kernels import gcn_agg as ga
from kagnn_tpu_torch.kernels import spmm
from kagnn_tpu_torch.models import NodeClassifier
from kagnn_tpu_torch.nn.mlp import MLP, TorchLinear
from kagnn_tpu_torch.train import make_node_steps, masked_softmax_cross_entropy
from kagnn_tpu_torch.utils.port import from_jax_variables, to_jax_variables

torch.set_num_threads(1)

KW = dict(mp_layers=3, num_features=8, hidden_channels=16, num_classes=3,
          skip=False, heads=2, architecture="mlp")
CONVS = ["gin", "gcn", "gat"]
VAL = dict(rtol=1e-4, atol=1e-5)
GRAD = dict(rtol=1e-3, atol=1e-5)
BF16_ULP = 2.0 ** -8
# biases that feed a BatchNorm directly: a GCN or GAT conv's, the last
# layer's of a GIN update MLP (2 layers)
BN_FED_BIAS = re.compile(r"convs\.\d+\.(bias|update\.layers\.1\.bias)")
GAT_LOGIT_GRAD = re.compile(r"convs\.\d+\.(att_src|att_dst)")
PLAIN = {"spmm": (spmm, "sorted_segment_sum_plain"),
         "gcn_agg": (ga, "gcn_agg_plain"),
         "gat_fwd": (gfu, "gat_fwd_plain"),
         "gat_dadst": (gbw, "gat_dadst_plain"),
         "gat_sender": (gbw, "gat_sender_plain")}
# GIN: the neighbour sum forward at every conv, A^T dz at every conv but
# the first; GCN: gcn_agg forward, its backward's A^T at every conv; GAT:
# the three attention kernels at every conv
PER_STEP = {"gin": {"spmm": 5},
            "gcn": {"gcn_agg": 3, "spmm": 3},
            "gat": {"gat_fwd": 3, "gat_dadst": 3, "gat_sender": 3}}


def _jax_leaves(tree):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_torch_linear_matches_jax(rng, dtype):
    x = rng.normal(size=(37, 11)).astype(np.float32)
    jx = jnp.asarray(x, getattr(jnp, dtype))
    jl = JaxTorchLinear(11, 5)
    v = jl.init(jax.random.key(0), jx)

    def jloss(params, xx):
        return (jl.apply({"params": params}, xx) ** 2).sum()

    want = jl.apply(v, jx)
    jg, jgx = jax.grad(jloss, argnums=(0, 1))(v["params"], jx.astype(jnp.float32))
    assert want.dtype == jnp.float32  # the f32 kernel promotes
    tl = TorchLinear(11, 5, device="cpu")
    with torch.no_grad():
        tl.weight.copy_(torch.from_numpy(np.asarray(v["params"]["kernel"]).T))
        tl.bias.copy_(torch.from_numpy(np.asarray(v["params"]["bias"])))
    tx = torch.tensor(np.asarray(jx.astype(jnp.float32))).to(getattr(torch, dtype))
    got = tl(tx)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **VAL)
    xg = tx.float().requires_grad_(True)
    (tl(xg) ** 2).sum().backward()
    np.testing.assert_allclose(tl.weight.grad.numpy(), np.asarray(jg["kernel"]).T, **GRAD)
    np.testing.assert_allclose(tl.bias.grad.numpy(), np.asarray(jg["bias"]), **GRAD)
    np.testing.assert_allclose(xg.grad.numpy(), np.asarray(jgx), **GRAD)


def _carry_mlp(v, tm):
    """A bare JAX MLP's variables into the port's MLP."""
    sd = {}
    for name, leaves in v["params"].items():
        if m := re.fullmatch(r"TorchLinear_(\d+)", name):
            sd[f"layers.{m.group(1)}.weight"] = torch.from_numpy(
                np.ascontiguousarray(np.asarray(leaves["kernel"]).T))
            sd[f"layers.{m.group(1)}.bias"] = torch.from_numpy(np.asarray(leaves["bias"]))
        else:
            i = re.fullmatch(r"MaskedBatchNorm_(\d+)", name).group(1)
            sd[f"norms.{i}.weight"] = torch.from_numpy(np.asarray(leaves["scale"]))
            sd[f"norms.{i}.bias"] = torch.from_numpy(np.asarray(leaves["bias"]))
    for name, leaves in v.get("batch_stats", {}).items():
        i = re.fullmatch(r"MaskedBatchNorm_(\d+)", name).group(1)
        sd[f"norms.{i}.running_mean"] = torch.from_numpy(np.asarray(leaves["mean"]))
        sd[f"norms.{i}.running_var"] = torch.from_numpy(np.asarray(leaves["var"]))
    tm.load_state_dict(sd)


@pytest.mark.parametrize("hidden_layers,batch_norm",
                         [(1, False), (2, False), (3, False), (2, True), (3, True)])
def test_mlp_matches_jax(rng, hidden_layers, batch_norm):
    """Train-mode values and gradients (parameters and input) against the
    JAX MLP, the new running statistics, then eval-mode values."""
    x = rng.normal(size=(40, 6)).astype(np.float32)
    mask = rng.random(40) < 0.7
    jm = JaxMLP(6, 9, 4, hidden_layers, batch_norm=batch_norm)
    v = jax.tree.map(np.asarray, jm.init(jax.random.key(1), jnp.asarray(x),
                                         mask=jnp.asarray(mask)))

    def jloss(params, xx):
        out, mut = jm.apply(dict(v, params=params), xx, mask=jnp.asarray(mask),
                            train=True, mutable=["batch_stats"])
        return (out ** 2).sum(), (out, mut)

    (_, (want, mut)), (jg, jgx) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(v["params"], jnp.asarray(x))
    tm = MLP(6, 9, 4, hidden_layers, batch_norm=batch_norm, device="cpu")
    _carry_mlp(v, tm)
    xt = torch.from_numpy(x).requires_grad_(True)
    got = tm(xt, mask=torch.from_numpy(mask), train=True)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **VAL)
    (got ** 2).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgx), **GRAD)
    for name, leaves in jg.items():
        i = name.split("_")[-1]
        if name.startswith("TorchLinear"):
            pairs = ((tm.layers[int(i)].weight.grad, np.asarray(leaves["kernel"]).T),
                     (tm.layers[int(i)].bias.grad, leaves["bias"]))
        else:
            pairs = ((tm.norms[int(i)].weight.grad, leaves["scale"]),
                     (tm.norms[int(i)].bias.grad, leaves["bias"]))
        for g, w in pairs:
            np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name, **GRAD)
    if batch_norm:
        for name, leaves in mut["batch_stats"].items():
            norm = tm.norms[int(name.split("_")[-1])]
            np.testing.assert_allclose(norm.running_mean.numpy(), leaves["mean"], **VAL)
            np.testing.assert_allclose(norm.running_var.numpy(), leaves["var"], **VAL)
    ve = dict(v, batch_stats=mut["batch_stats"]) if batch_norm else v
    want_eval = jm.apply(ve, jnp.asarray(x), mask=jnp.asarray(mask), train=False)
    with torch.no_grad():
        got_eval = tm(torch.from_numpy(x), mask=torch.from_numpy(mask), train=False)
    np.testing.assert_allclose(got_eval.numpy(), np.asarray(want_eval), **VAL)


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
    """The JAX model's initial variables per conv, made once."""
    gj, _, _ = graph
    made = {}

    def get(conv):
        if conv not in made:
            kw = dict(KW, conv_type=conv)
            with jsegment.use_pallas_spmm(False):
                v = JaxNodeClassifier(fused=False, **kw).init(
                    jax.random.key(0), gj)
            made[conv] = kw, jax.tree.map(np.asarray, v)
        return made[conv]
    return get


def _jax_run(model, v, gj, mask, n):
    """n steps of the JAX train step (masked CE, optax Adam(1e-3)): the
    loss of each step, and the logits and parameter gradients of the
    first."""
    def loss_fn(params):
        out, _ = model.apply(dict(v, params=params), gj, train=True,
                             rngs={"dropout": jax.random.key(0)},
                             mutable=["batch_stats"])
        return jlosses.masked_softmax_cross_entropy(out, gj.y, mask), out

    grad_fn = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    tx = optax.adam(1e-3)
    params = v["params"]
    opt = tx.init(params)
    losses = []
    for i in range(n):
        (loss, out), grads = grad_fn(params)
        if i == 0:
            first = np.asarray(out), grads
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


@pytest.mark.parametrize("conv", CONVS)
def test_weight_carrier_round_trip(variables, conv):
    """JAX tree -> state_dict -> JAX tree is the identity (kernels
    transposed both ways), and the port's own state_dict maps onto the JAX
    tree's structure and shapes."""
    kw, v = variables(conv)
    back = to_jax_variables(from_jax_variables(v))
    assert jax.tree.structure(back) == jax.tree.structure(v)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(v)):
        np.testing.assert_array_equal(a, b)
    own = to_jax_variables(NodeClassifier(device="cpu", **kw).state_dict())
    assert jax.tree.structure(own) == jax.tree.structure(v)
    for a, b in zip(jax.tree.leaves(own), jax.tree.leaves(v)):
        assert a.shape == b.shape


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("conv", CONVS)
def test_f32_step_matches_jax_unfused(graph, variables, conv, fused):
    gj, gt, mask = graph
    kw, v = variables(conv)
    jm = JaxNodeClassifier(fused=False, **kw)
    with jsegment.use_pallas_spmm(False):
        traj_j, oj, gj_grads = _jax_run(jm, v, gj, mask, 3)
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
    np.testing.assert_allclose(_port_losses(_port(kw, v, fused), gt, mask, 3),
                               traj_j, **VAL)


def conv_scale(grads, name):
    """The largest gradient of the conv that parameter `name` belongs to."""
    conv = name.split(".")[1]
    return max(np.abs(a).max() for k, a in grads.items()
               if k.startswith(f"convs.{conv}."))


@pytest.mark.parametrize("conv", CONVS)
def test_bf16_step_matches_jax_fused(graph, variables, conv):
    gj, gt, mask = graph
    kw, v = variables(conv)
    jm = JaxNodeClassifier(fused=True, compute_dtype=jnp.bfloat16, **kw)
    with jsegment.use_pallas_spmm(True, interpret=True):
        traj_j, oj, gj_grads = _jax_run(jm, v, gj, mask, 3)
    m = _port(kw, v, True, torch.bfloat16)
    m.train()
    logits = m(gt)
    masked_softmax_cross_entropy(logits, gt.y, torch.from_numpy(mask)).backward()
    ot = logits.detach().numpy()
    nm = gt.node_mask.numpy()
    assert ot.dtype == np.float32
    ratios = {"logits": np.abs(ot[nm] - oj[nm]).max()
              / (4 * BF16_ULP * np.abs(oj[nm]).max())}
    want = {k: t.numpy() for k, t in
            from_jax_variables({"params": gj_grads}).items()}
    for name, p in m.named_parameters():
        assert p.dtype == torch.float32  # f32 master weights
        g, w = p.grad.numpy(), want[name]
        if BN_FED_BIAS.fullmatch(name):
            ratios[name] = (max(np.abs(g).max(), np.abs(w).max())
                            / (8 * BF16_ULP * conv_scale(want, name)))
        elif conv == "gat" and GAT_LOGIT_GRAD.fullmatch(name):
            ratios[name] = np.abs(g - w).max() / (8 * BF16_ULP * conv_scale(want, name))
        else:
            ratios[name] = np.abs(g - w).max() / (8 * BF16_ULP * np.abs(w).max())
    traj_t = _port_losses(_port(kw, v, True, torch.bfloat16), gt, mask, 3)
    ratios["trajectory"] = max(abs(a - b) / (4 * BF16_ULP * abs(b))
                               for a, b in zip(traj_t, traj_j))
    worst = max(ratios, key=ratios.get)
    print(f"{conv}/mlp bf16 against JAX fused: worst {worst} at "
          f"{ratios[worst]:.4f} of its bar")
    assert all(r <= 1.0 for r in ratios.values()), ratios


@pytest.mark.parametrize("conv", CONVS)
def test_bf16_paths_promote_to_f32_where_the_jax_model_does(graph, variables, conv):
    """Under bf16 the dtype of every conv's output and of the logits is the
    JAX model's (flax's capture_intermediates): f32 from the first dense
    product on; only gin/mlp's conv-0 aggregate stays bf16."""
    gj, gt, mask = graph
    kw, v = variables(conv)
    _, inter = JaxNodeClassifier(fused=False, compute_dtype=jnp.bfloat16, **kw).apply(
        v, gj, train=True, rngs={"dropout": jax.random.key(0)},
        mutable=["batch_stats", "intermediates"], capture_intermediates=True)
    convs = {k: v["__call__"][0].dtype for k, v in inter["intermediates"].items()
             if re.fullmatch(r"(GIN|GCN|GAT)Conv_\d", k)}
    m = _port(kw, v, True, torch.bfloat16)
    m.train()
    seen, aggs = [], []
    for c in m.convs:
        c.register_forward_hook(lambda mod, a, out: seen.append(out.dtype))
    if conv == "gin":
        orig = spmm.sorted_segment_sum_plain

        def spy(msgs, *a):
            aggs.append(msgs.dtype)
            return orig(msgs, *a)
        spmm.sorted_segment_sum_plain = spy
    try:
        logits = m(gt)
    finally:
        if conv == "gin":
            spmm.sorted_segment_sum_plain = orig
    assert [str(d).split(".")[-1] for d in seen] == [
        str(convs[f"{conv.upper()}Conv_{i}"]) for i in range(3)] == ["float32"] * 3
    assert logits.dtype == torch.float32
    if conv == "gin":
        assert aggs == [torch.bfloat16, torch.float32, torch.float32]


@pytest.mark.parametrize("conv", CONVS)
def test_step_calls_each_kernel_per_step(graph, variables, conv, monkeypatch):
    """The launches of one bf16 train step per kernel: no layer kernel
    runs on these paths; gin/mlp sums through the segment-sum kernel (conv
    0's forward in bf16, the other four in f32), gcn/mlp and gat/mlp run
    their aggregates in f32."""
    gj, gt, mask = graph
    kw, v = variables(conv)
    calls = {}

    def counting(key, fn):
        def f(*a, **k):
            calls.setdefault(key, []).append(a[0].dtype)
            return fn(*a, **k)
        return f

    for key, (mod, name) in PLAIN.items():
        monkeypatch.setattr(mod, name, counting(key, getattr(mod, name)))
    m = _port(kw, v, True, torch.bfloat16)
    step, _ = make_node_steps(m, torch.optim.Adam(m.parameters(), lr=1e-3))
    step(gt, torch.from_numpy(mask))
    assert {k: len(n) for k, n in calls.items()} == PER_STEP[conv]
    dtypes = [d for n in calls.values() for d in n]
    if conv == "gin":
        assert dtypes.count(torch.bfloat16) == 1 and calls["spmm"][0] == torch.bfloat16
    else:
        assert set(dtypes) == {torch.float32}
