"""The edge partition of the port (`kagnn_tpu_torch/dist/partition.py`, the
edge-axis collectives of `ops/segment.py`) against the JAX package's on the
CPU, and the scaling driver:

  * `pad_edges_to` and the edge shards of `dist/mesh.py` against the JAX
    padding and slicing;
  * the edge-partitioned step for gin, gcn and gat (FastKAN transforms, as
    the JAX tests run them) at D = 2 and D = 4 against the JAX
    `make_edge_partitioned_node_step` from the same weights: the loss and
    every gradient leaf (read off one SGD step of rate 1), the port both
    unfused and with fused=True (its routes under the edge axis: the
    segment-sum kernel on the shard then the all-reduce for GIN and GCN,
    the plain composition for GAT; the JAX fused and unfused f32 models
    differ only in summation order), with the parameters equal on every
    rank. The port's ranks are gloo processes (`dist/launch.py`, a
    FileStore, one thread each), one spawn for each D;
  * a fused GIN/KAN model under the edge partition: the JAX step raises
    (its custom VJP's weight gradients vary over the edge axis), and so
    does the port's;
  * `python -m kagnn_tpu_torch.experiments.scaling` at a tiny size with
    `--device cpu --backend gloo`, both strategies: the JAX report's rows;
    asked for more nccl ranks than there are cards, it raises before any
    run.

Values rtol 1e-4 / atol 1e-5, gradients rtol 1e-3 / atol 1e-5.
"""
import json

import jax
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh

from kagnn_tpu.dist import partition as jpart
from kagnn_tpu.graphs import single_graph as jax_single_graph
from kagnn_tpu.models import NodeClassifier as JaxNodeClassifier
from kagnn_tpu.train import create_train_state
from kagnn_tpu_torch.data import community_node_graph
from kagnn_tpu_torch.dist import partition as tpart
from kagnn_tpu_torch.dist.launch import launch
from kagnn_tpu_torch.dist.mesh import edge_shard
from kagnn_tpu_torch.dist.runs import many_rank
from kagnn_tpu_torch.experiments import scaling
from kagnn_tpu_torch.graphs import single_graph
from kagnn_tpu_torch.models import NodeClassifier
from kagnn_tpu_torch.ops import segment
from kagnn_tpu_torch.utils.port import from_jax_variables

torch.set_num_threads(1)
pytestmark = pytest.mark.skipif(len(jax.devices()) < 8,
                                reason="needs 8 (virtual) devices")

VAL = dict(rtol=1e-4, atol=1e-5)
GRAD = dict(rtol=1e-3, atol=1e-5)
KW = dict(mp_layers=2, num_features=6, hidden_channels=8, num_classes=3,
          skip=False, grid_size=4, dropout=0.0)
CONVS = ("gin", "gcn", "gat")
WIDTHS = (2, 4)
CASES = [(c, n, f) for n in WIDTHS for c in CONVS for f in (False, True)]
EDGE_LEAVES = ("senders", "receivers", "edge_mask")


@pytest.fixture(scope="module")
def graph():
    d = community_node_graph(n_nodes=96, n_classes=3, num_features=6, seed=5)
    arrs = {k: d[k] for k in ("senders", "receivers", "nodes", "y")}
    gj = jax_single_graph(**arrs, edge_pad_multiple=128)
    gt = single_graph(**arrs, device="cpu")
    mask = np.zeros(gj.n_node_pad, bool)
    mask[:d["n_node"]] = d["masks"]["train"]
    return d, gj, gt, mask


def _mesh(n):
    return Mesh(np.asarray(jax.devices()[:n]).reshape(n), ("graph",))


def _jax_edge_step(gj, mask, conv, n, fused=False, arch="fastkan"):
    """The JAX edge-partitioned step with SGD(1): the initial variables,
    the loss and the gradients (p - p_new) in the port's names."""
    model = JaxNodeClassifier(conv_type=conv, architecture=arch, fused=fused, **KW)
    tx = optax.sgd(1.0)
    state, _ = create_train_state(model, jax.random.key(0), gj, tx)
    step = jpart.make_edge_partitioned_node_step(model, tx, _mesh(n))
    new, loss = step(state, gj, mask, jax.random.key(3))
    grads = jax.tree.map(lambda a, b: np.asarray(a) - np.asarray(b), state.params, new.params)
    return (jax.tree.map(np.asarray, state.variables()), float(loss),
            {k: v.numpy() for k, v in from_jax_variables({"params": grads}).items()})


@pytest.fixture(scope="module")
def jax_steps(graph):
    _, gj, _, mask = graph
    return {(c, n): _jax_edge_step(gj, mask, c, n) for n in WIDTHS for c in CONVS}


@pytest.fixture(scope="module")
def port_runs(graph, jax_steps, tmp_path_factory):
    d, _, _, mask = graph
    out = {}
    for n in WIDTHS:
        jobs = [("node", dict(
            graph={k: d[k] for k in ("senders", "receivers", "nodes", "y", "n_node")},
            strategy="edge", device="cpu", opt=("sgd", 1.0), steps=1, mask=mask,
            state={k: v.numpy() for k, v in from_jax_variables(jax_steps[(c, n)][0]).items()},
            model=dict(conv_type=c, architecture="fastkan", fused=f, seed=0, **KW)))
            for c in CONVS for f in (False, True)]
        res = launch(many_rank, n, (jobs,), backend="gloo", device="cpu", timeout=300,
                     threads=1, store_path=tmp_path_factory.mktemp(f"edge{n}") / "store")
        for i, (c, f) in enumerate((c, f) for c in CONVS for f in (False, True)):
            out[(c, n, f)] = [r[i] for r in res]
    return out


@pytest.mark.parametrize("multiple", [1, 2, 3, 4, 7])
def test_pad_edges_to_equals_jax(graph, multiple):
    """The repadded edge leaves equal the JAX function's, and the edge
    shards are the contiguous slices of them, with their row pointers and
    sender sort rebuilt and the node leaves whole."""
    _, gj, gt, _ = graph
    # the JAX function has no fill for the sender-sorted views, so it
    # raises on a graph that ships them once it pads; its edge leaves are
    # taken from the graph without them
    a = jpart.pad_edges_to(gj.replace(senders_perm=None, senders_sorted=None), multiple)
    b = tpart.pad_edges_to(gt, multiple)
    if multiple == 7:
        with pytest.raises(KeyError):
            jpart.pad_edges_to(gj, multiple)
    for f in EDGE_LEAVES:
        np.testing.assert_array_equal(np.asarray(getattr(a, f)), getattr(b, f).numpy())
    e = b.n_edge_pad // multiple
    for k in range(multiple):
        s = edge_shard(b, k, multiple)
        for f in EDGE_LEAVES:
            np.testing.assert_array_equal(getattr(s, f).numpy(),
                                          np.asarray(getattr(a, f))[k * e:(k + 1) * e])
        assert int(s.recv_row_ptr[-1]) == e and int(s.send_row_ptr[-1]) == e
        np.testing.assert_array_equal(s.senders_sorted.numpy(),
                                      np.sort(s.senders.numpy(), kind="stable"))
        assert s.in_degrees is gt.in_degrees and s.nodes is gt.nodes


@pytest.mark.parametrize("conv,n,fused", CASES,
                         ids=[f"{c}-d{n}-{'fused' if f else 'plain'}" for c, n, f in CASES])
def test_edge_step_matches_jax(jax_steps, port_runs, conv, n, fused):
    """The port's edge-partitioned step against the JAX one (unfused) from
    the same weights: loss, every gradient leaf, equal parameters on every
    rank."""
    _, loss, grads = jax_steps[(conv, n)]
    res = port_runs[(conv, n, fused)]
    np.testing.assert_allclose(res[0]["losses"][0], loss, **VAL)
    assert set(res[0]["grads"]) == set(grads)
    for k, v in grads.items():
        np.testing.assert_allclose(res[0]["grads"][k], v, **GRAD, err_msg=k)
    assert all(np.array_equal(r["params"], res[0]["params"]) for r in res)


def test_fused_gin_kan_is_refused_under_the_edge_axis(graph):
    """The JAX edge-partitioned step raises for a fused GIN/KAN model; the
    port's fused GIN entry raises under an edge axis too (the aggregate of
    the shard's edges would feed a nonlinear layer before the all-reduce).
    Outside the edge axis the same model runs."""
    _, gj, gt, mask = graph
    with pytest.raises(ValueError):
        _jax_edge_step(gj, mask, "gin", 2, fused=True, arch="kan")
    m = NodeClassifier(conv_type="gin", architecture="kan", fused=True, seed=0,
                       device="cpu", **KW)
    with pytest.raises(ValueError, match="edge partition"):
        with segment.edge_axis(object()):
            m(gt)
    assert torch.isfinite(m(gt)).all()


@pytest.mark.parametrize("strategy", ["halo", "allreduce"])
def test_scaling_driver_prints_the_jax_rows(strategy, capsys):
    """The scaling driver at a tiny size on gloo CPU ranks (1 and 2): one
    JSON row a shard count with the JAX report's keys."""
    scaling.main(["--devices", "1", "2", "--n_nodes", "300", "--n_edges", "1500",
                  "--hidden", "8", "--iters", "1", "--strategy", strategy,
                  "--device", "cpu", "--backend", "gloo"])
    rows = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("{")]
    assert [r["n_devices"] for r in rows] == [1, 2]
    keys = {"n_devices", "sec_per_step", "edges_per_s", "scaling_efficiency"}
    if strategy == "halo":
        keys |= {"halo_rows_per_dev", "boundary_rows", "block"}
    for r in rows:
        assert keys <= set(r) and r["sec_per_step"] > 0 and np.isfinite(r["loss"])
    assert rows[0]["scaling_efficiency"] == 1.0


@pytest.mark.parametrize("strategy", ["halo", "allreduce"])
def test_scaling_driver_refuses_more_nccl_ranks_than_cards(strategy, monkeypatch):
    """nccl takes one card a rank: on a host with one card, `--devices 1 2
    --backend nccl` raises before any run (no rank is spawned, no row is
    printed), and nccl on the CPU raises too. Nothing moves to gloo."""
    import importlib

    launch_mod = importlib.import_module("kagnn_tpu_torch.dist.launch")

    def no_run(*a, **k):
        raise AssertionError("a run was started")

    monkeypatch.setattr(launch_mod, "launch", no_run)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="nccl takes one card a rank: 2 ranks"):
        scaling.main(["--devices", "1", "2", "--strategy", strategy,
                      "--backend", "nccl"])
    with pytest.raises(ValueError, match="nccl backend runs on CUDA"):
        scaling.main(["--devices", "1", "--strategy", strategy,
                      "--backend", "nccl", "--device", "cpu"])
