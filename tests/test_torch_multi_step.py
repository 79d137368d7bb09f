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
  * the same over a second batch of the first's shapes (its features
    redrawn), and against eager steps on new tensors;
  * a model with dropout: the losses of eager steps drawing from the same
    generator, bit for bit;
  * `capture_signature`, which keys the card's captures: equal for a batch
    of the same shapes and counts, different for another n_edge;
  * the error (`require_capturable`, which the card path calls) for an
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
from kagnn_tpu_torch.train.loops import capture_signature, require_capturable
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


def _second_batch(d, seed=9):
    """The graph of `d` with its node features redrawn from another seed:
    the same shapes and counts."""
    nodes = np.random.default_rng(seed).normal(
        size=d["nodes"].shape).astype(np.float32)
    return nodes, single_graph(d["senders"], d["receivers"], nodes=nodes,
                               y=d["y"], device="cpu")


def test_gin_kan_losses_match_jax_over_two_batches(graph):
    """Three steps on the first batch, then three on a second of the same
    shapes (the features redrawn), against the JAX multi-step on the same
    two batches, dropout-free."""
    d, gt, mask = graph
    nodes2, gt2 = _second_batch(d)
    gj1 = jax_single_graph(d["senders"], d["receivers"], nodes=d["nodes"], y=d["y"])
    gj2 = jax_single_graph(d["senders"], d["receivers"], nodes=nodes2, y=d["y"])
    kw = dict(KW, conv_type="gin", architecture="kan")
    jm = JaxNodeClassifier(fused=False, **kw)
    jmask = mask.numpy()
    with jsegment.use_pallas_spmm(False):
        state, tx = create_train_state(jm, jax.random.key(0), gj1, optax.adam(1e-3))
        v0 = jax.tree.map(np.asarray, state.variables())
        multi_j = jax_multi_step(jm, tx, 3)
        state, l1 = multi_j(state, gj1, jmask, jax.random.key(1))
        _, l2 = multi_j(state, gj2, jmask, jax.random.key(2))
    want = np.concatenate([np.asarray(l1), np.asarray(l2)])
    m = NodeClassifier(fused=True, device="cpu", **kw)
    m.load_state_dict(from_jax_variables(v0))
    multi = make_node_multi_step(m, torch.optim.Adam(m.parameters(), lr=1e-3), 3)
    got = torch.cat([multi(gt, mask), multi(gt2, mask)]).numpy()
    np.testing.assert_allclose(got, want, **VAL)


def test_multi_takes_the_first_calls_tensors_only(graph):
    """Any batch of the captured shapes runs, not only the first call's
    tensors: new tensors of the same values and a second batch give the
    losses of eager steps on them, bit for bit; a batch with another
    n_edge has another capture signature (the card captures it anew)."""
    d, gt, mask = graph
    m1, o1 = _model("gcn", "mlp")
    m2, o2 = _model("gcn", "mlp")
    multi = make_node_multi_step(m1, o1, 2)
    step, _ = make_node_steps(m2, o2)
    _, gt2 = _second_batch(d)
    batches = [(gt, mask), (gt, mask.clone()), (gt2, mask)]
    got = torch.cat([multi(*b) for b in batches])
    want = torch.stack([step(*b) for b in batches for _ in range(2)])
    assert torch.equal(got, want)
    assert capture_signature(gt, mask) == capture_signature(gt2, mask.clone())
    fewer = single_graph(d["senders"][:-5], d["receivers"][:-5],
                         nodes=d["nodes"], y=d["y"], device="cpu")
    assert fewer.n_edge_pad == gt.n_edge_pad and fewer.n_edge != gt.n_edge
    assert capture_signature(fewer, mask) != capture_signature(gt, mask)


def test_multi_refuses_dropout_and_non_capturable_optimizers(graph):
    """A model with dropout runs (it refused it before): n steps of multi
    draw the masks from `model.dropout_generator` as n eager steps from the
    same seed do, bit for bit. An optimizer whose state is not kept on the
    card is still refused (`require_capturable`, which the card path
    calls)."""
    _, gt, mask = graph
    m1, o1 = _model("gin", "kan", dropout=0.5)
    m2, o2 = _model("gin", "kan", dropout=0.5)
    multi = make_node_multi_step(m1, o1, 3)
    got = torch.cat([multi(gt, mask), multi(gt, mask)])
    step, _ = make_node_steps(m2, o2)
    want = torch.stack([step(gt, mask) for _ in range(6)])
    assert torch.equal(got, want)
    m3, o3 = _model("gin", "kan")
    dry = torch.stack([make_node_steps(m3, o3)[0](gt, mask) for _ in range(6)])
    assert not torch.equal(got, dry)  # the masks were drawn
    with pytest.raises(ValueError, match="capturable=True"):
        require_capturable(o1)
    require_capturable(torch.optim.Adam(m1.parameters(), lr=1e-3, capturable=True))
