"""Data parallelism of the port (`kagnn_tpu_torch/dist/sharded.py`,
`dist/mesh.py`) against the JAX package's `make_sharded_train_step` on the
CPU: graph classification over padded batches of 4 molecules a replica
(data/synthetic's random_molecule_graphs, one-hot atom types), the JAX
step on the virtual CPU devices, the port's on gloo ranks
(`dist/launch.py`, a FileStore, one thread each, one spawn a rank count):

  * 2 replicas on 2 ranks (mesh (2, 1)) for gin/kan (unfused and fused)
    and gcn/fastkan: the mean loss, every gradient leaf (read off one SGD
    step of rate 1) and the BatchNorm running statistics after the step
    (the mean of the replicas'), with the parameters equal on both ranks;
  * 2 replicas on 4 ranks (mesh (2, 2): each replica's edges split over
    the graph axis, the edge partition inside data parallelism) for
    gin/kan against the JAX step on the (2, 2) mesh;
  * `make_mesh`'s layout (row-major, as the JAX mesh reshapes its
    devices) and `stack_batches`' check of one padding.

Values rtol 1e-4 / atol 1e-5, gradients rtol 1e-3 / atol 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from kagnn_tpu.data.synthetic import random_molecule_graphs
from kagnn_tpu.dist.mesh import make_mesh as jax_make_mesh
from kagnn_tpu.dist.sharded import (make_sharded_train_step, shard_stacked_batch,
                                    stack_batches as jax_stack_batches)
from kagnn_tpu.graphs import batch_graphs, pad_spec_for
from kagnn_tpu.models import GraphClassifier as JaxGraphClassifier
from kagnn_tpu.train import losses as jlosses
from kagnn_tpu.train.loops import TrainState
from kagnn_tpu_torch.dist.launch import launch
from kagnn_tpu_torch.dist.runs import dp_batches, many_rank
from kagnn_tpu_torch.dist.sharded import stack_batches
from kagnn_tpu_torch.utils.port import from_jax_variables

torch.set_num_threads(1)
pytestmark = pytest.mark.skipif(len(jax.devices()) < 8,
                                reason="needs 8 (virtual) devices")

VAL = dict(rtol=1e-4, atol=1e-5)
GRAD = dict(rtol=1e-3, atol=1e-5)
PER, REPLICAS, SEED = 4, 2, 1
KW = dict(gnn_layers=2, num_features=21, hidden_dim=8, num_classes=2,
          grid_size=3, spline_order=2)
# (conv, arch, the port's fused, mesh shape); the JAX step runs unfused
CASES = [("gin", "kan", False, (2, 1)), ("gin", "kan", True, (2, 1)),
         ("gcn", "fastkan", False, (2, 1)), ("gin", "kan", False, (2, 2))]
IDS = [f"{c}-{a}-{'fused' if f else 'plain'}-{m[0]}x{m[1]}" for c, a, f, m in CASES]
MESHES = [(4, 1), (2, 2), (1, 4)]


def _jax_batches():
    graphs = random_molecule_graphs(n_graphs=PER * REPLICAS, seed=SEED)
    spec = pad_spec_for(graphs, PER)
    return [b.replace(nodes=jax.nn.one_hot(b.nodes[:, 0], KW["num_features"]),
                      y=b.y.astype(jnp.int32))
            for b in (batch_graphs(graphs[i * PER:(i + 1) * PER], spec)
                      for i in range(REPLICAS))]


def _jax_dp_step(conv, arch, mesh_shape):
    """The JAX DP step with SGD(1): initial variables, loss, gradients and
    batch stats after the step, in the port's names."""
    batches = _jax_batches()
    model = JaxGraphClassifier(conv_type=conv, architecture=arch, **KW)
    variables = model.init({"params": jax.random.key(0)}, batches[0])
    tx = optax.sgd(1.0)
    state = TrainState(params=variables["params"], buffers=variables.get("buffers", {}),
                       batch_stats=variables.get("batch_stats", {}),
                       opt_state=tx.init(variables["params"]),
                       step=jnp.zeros((), jnp.int32))
    n = int(np.prod(mesh_shape))
    mesh = jax_make_mesh(mesh_shape, ("data", "graph"), devices=jax.devices()[:n])
    stacked = shard_stacked_batch(mesh, jax_stack_batches(batches))
    step = make_sharded_train_step(
        model, tx, mesh, lambda out, b: jlosses.masked_nll(out, b.y, b.graph_mask))
    new, loss = step(state, stacked, jax.random.split(jax.random.key(42), REPLICAS))
    grads = jax.tree.map(lambda a, b: np.asarray(a) - np.asarray(b), state.params, new.params)
    stats = from_jax_variables({"batch_stats": jax.tree.map(np.asarray, new.batch_stats)})
    return (jax.tree.map(np.asarray, variables), float(loss),
            {k: v.numpy() for k, v in from_jax_variables({"params": grads}).items()},
            {k: v.numpy() for k, v in stats.items()})


@pytest.fixture(scope="module")
def jax_steps():
    return {(c, a, m): _jax_dp_step(c, a, m) for c, a, _, m in CASES}


def _spec(conv, arch, fused, mesh, variables):
    return dict(batch=PER, replicas=REPLICAS, seed=SEED, opt=("sgd", 1.0), steps=1,
                device="cpu", mesh=mesh,
                state={k: v.numpy() for k, v in from_jax_variables(variables).items()},
                model=dict(conv_type=conv, architecture=arch, fused=fused, **KW))


@pytest.fixture(scope="module")
def port_runs(jax_steps, tmp_path_factory):
    out = {}
    for world in (2, 4):
        cases = [c for c in CASES if int(np.prod(c[3])) == world]
        jobs = [("dp", _spec(*c, jax_steps[(c[0], c[1], c[3])][0])) for c in cases]
        if world == 4:
            jobs += [("mesh", dict(shape=m)) for m in MESHES]
        res = launch(many_rank, world, (jobs,), backend="gloo", device="cpu", timeout=300,
                     threads=1, store_path=tmp_path_factory.mktemp(f"dp{world}") / "store")
        for i, c in enumerate(cases):
            out[c] = [r[i] for r in res]
        for i, m in enumerate(MESHES if world == 4 else ()):
            out[m] = [r[len(cases) + i] for r in res]
    return out


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_dp_step_matches_jax(jax_steps, port_runs, case):
    conv, arch, _, mesh = case
    _, loss, grads, stats = jax_steps[(conv, arch, mesh)]
    res = port_runs[case]
    np.testing.assert_allclose(res[0]["losses"][0], loss, **VAL)
    assert set(res[0]["grads"]) == set(grads)
    for k, v in grads.items():
        np.testing.assert_allclose(res[0]["grads"][k], v, **GRAD, err_msg=k)
    assert set(res[0]["stats"]) == set(stats)
    for k, v in stats.items():
        np.testing.assert_allclose(res[0]["stats"][k], v, **VAL, err_msg=k)
    for r in res:
        assert np.array_equal(r["params"], res[0]["params"])
        assert all(np.array_equal(r["stats"][k], res[0]["stats"][k]) for k in stats)


@pytest.mark.parametrize("shape", MESHES, ids=[f"{a}x{b}" for a, b in MESHES])
def test_make_mesh_lays_ranks_out_row_major(port_runs, shape):
    """Rank r sits at np.unravel_index(r, shape), and each axis's group
    holds the ranks of its line, as the JAX mesh reshapes its devices."""
    ranks = np.arange(4).reshape(shape)
    for r, res in enumerate(port_runs[shape]):
        c = np.unravel_index(r, shape)
        assert tuple(res["coords"]) == tuple(int(v) for v in c)
        assert res["sizes"] == list(shape)
        assert res["lines"]["data"] == sorted(ranks[:, c[1]].tolist())
        assert res["lines"]["graph"] == sorted(ranks[c[0], :].tolist())


def test_stack_batches_takes_one_padding():
    spec = dict(batch=PER, replicas=REPLICAS, seed=SEED, model=dict(num_features=21))
    batches = dp_batches(spec, "cpu")
    assert stack_batches(batches) == tuple(batches)
    other = dp_batches(dict(spec, batch=3), "cpu")
    with pytest.raises(ValueError, match="padding"):
        stack_batches([batches[0], other[0]])
