"""`train/loops.py::make_node_multi_step` on the CPU, where each call is a
loop over the train step (on the card it replays one CUDA graph of the n
steps: tests/test_torch_cuda.py and chip_smoke.py hold it against eager
steps there).

  * n steps of `multi` equal n separate `train_step`s bit for bit: the
    losses, every parameter, every BatchNorm statistic and Adam's state
    (3 conv layers, width 16, 120 nodes; one path per architecture);
  * gin/kan's losses against the JAX `make_node_multi_step` (a `lax.scan`
    of the step) on carried weights in f32, over two calls of 3 steps
    (rtol 1e-4 / atol 1e-5: the same f32 arithmetic in another summation
    order);
  * the errors: a call with other tensors than the first call's, a model
    with dropout, and (`require_capturable`, which the card path calls) an
    optimizer whose state is not kept on the card.
"""
import jax
import numpy as np
import optax
import pytest
import torch

from kagnn_tpu.graphs import single_graph as jax_single_graph
from kagnn_tpu.models import NodeClassifier as JaxNodeClassifier
from kagnn_tpu.ops import segment as jsegment
from kagnn_tpu.train.loops import create_train_state
from kagnn_tpu.train.loops import make_node_multi_step as jax_multi_step
from kagnn_tpu_torch.data import community_node_graph
from kagnn_tpu_torch.graphs import single_graph
from kagnn_tpu_torch.models import NodeClassifier
from kagnn_tpu_torch.train import make_node_multi_step, make_node_steps
from kagnn_tpu_torch.train.loops import require_capturable
from kagnn_tpu_torch.utils.port import from_jax_variables

torch.set_num_threads(1)

KW = dict(mp_layers=3, num_features=8, hidden_channels=16, num_classes=3,
          grid_size=4, spline_order=3, skip=False, heads=2)
VAL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module")
def graph():
    d = community_node_graph(n_nodes=120, n_classes=3, num_features=8, seed=3)
    gt = single_graph(d["senders"], d["receivers"], nodes=d["nodes"],
                      y=d["y"], device="cpu")
    mask = torch.zeros(gt.n_node_pad, dtype=torch.bool)
    mask[:d["n_node"]] = torch.from_numpy(d["masks"]["train"])
    return d, gt, mask


def _model(conv, arch, **kw):
    m = NodeClassifier(**dict(KW, conv_type=conv, architecture=arch, **kw),
                       fused=True, device="cpu", seed=4)
    return m, torch.optim.Adam(m.parameters(), lr=1e-3)


@pytest.mark.parametrize("conv,arch", [("gin", "kan"), ("gcn", "fastkan"),
                                       ("gat", "mlp")])
def test_multi_equals_separate_steps(graph, conv, arch):
    _, gt, mask = graph
    m1, o1 = _model(conv, arch)
    m2, o2 = _model(conv, arch)
    multi = make_node_multi_step(m1, o1, 3)
    got = torch.cat([multi(gt, mask), multi(gt, mask)])
    step, _ = make_node_steps(m2, o2)
    want = torch.stack([step(gt, mask) for _ in range(6)])
    assert got.dtype == torch.float32 and got.shape == (6,)
    assert torch.equal(got, want)
    for (n, a), (_, b) in zip(m1.state_dict().items(), m2.state_dict().items()):
        assert torch.equal(a, b), n
    for p1, p2 in zip(m1.parameters(), m2.parameters()):
        for k, v in o1.state[p1].items():
            assert torch.equal(v, o2.state[p2][k]), k


def test_gin_kan_losses_match_jax_multi_step(graph):
    d, gt, mask = graph
    gj = jax_single_graph(d["senders"], d["receivers"], nodes=d["nodes"], y=d["y"])
    kw = dict(KW, conv_type="gin", architecture="kan")
    jm = JaxNodeClassifier(fused=False, **kw)
    jmask = mask.numpy()
    with jsegment.use_pallas_spmm(False):
        state, tx = create_train_state(jm, jax.random.key(0), gj, optax.adam(1e-3))
        v0 = jax.tree.map(np.asarray, state.variables())
        multi_j = jax_multi_step(jm, tx, 3)
        state, l1 = multi_j(state, gj, jmask, jax.random.key(1))
        _, l2 = multi_j(state, gj, jmask, jax.random.key(2))
    want = np.concatenate([np.asarray(l1), np.asarray(l2)])
    m = NodeClassifier(fused=True, device="cpu", **kw)
    m.load_state_dict(from_jax_variables(v0))
    multi = make_node_multi_step(m, torch.optim.Adam(m.parameters(), lr=1e-3), 3)
    got = torch.cat([multi(gt, mask), multi(gt, mask)]).numpy()
    np.testing.assert_allclose(got, want, **VAL)


def test_multi_takes_the_first_calls_tensors_only(graph):
    d, gt, mask = graph
    m, o = _model("gcn", "mlp")
    multi = make_node_multi_step(m, o, 2)
    multi(gt, mask)
    with pytest.raises(ValueError, match="same tensors"):
        multi(gt, mask.clone())
    with pytest.raises(ValueError, match="same tensors"):
        multi(single_graph(d["senders"], d["receivers"], nodes=d["nodes"],
                           y=d["y"], device="cpu"), mask)
    assert multi(gt, mask).shape == (2,)


def test_multi_refuses_dropout_and_non_capturable_optimizers(graph):
    m, o = _model("gin", "mlp", dropout=0.5)
    with pytest.raises(ValueError, match="dropout"):
        make_node_multi_step(m, o, 2)
    with pytest.raises(ValueError, match="capturable=True"):
        require_capturable(o)
    require_capturable(torch.optim.Adam(m.parameters(), lr=1e-3, capturable=True))
