"""The halo-exchange node partition of the port (`kagnn_tpu_torch/dist/halo.py`
and the halo state of `ops/segment.py`) against the JAX package's on the
CPU: the port's ranks are 4 gloo processes (`dist/launch.py`, a FileStore,
one thread each, every configuration in one spawn), the JAX side runs in
this process on 4 of the 8 virtual CPU devices, with its Pallas kernels in
interpret mode where it routes to them.

  * the plan, array for array, on several graphs and shard counts;
  * `halo_exchange` and its backward against a numpy replay of the plan;
  * both halo entries of the fused GIN kernels (`gin_kan_fused_halo`,
    `gin_fastkan_fused_halo`, the plain versions on the CPU) against the
    JAX entries under shard_map (their Pallas kernels in interpret mode),
    in f32: the output, dx and the weight gradients summed over the shards;
  * the halo step for {gin, gcn, gat} x {mlp, kan, fastkan} at D = 4 in
    f32: the loss and every gradient leaf (the JAX step's, read off one
    SGD step of rate 1 as the JAX tests do: Adam's m/sqrt(v) would turn a
    sign flip of a near-zero gradient into a full step), and the evaluation
    after it; and the port's fused=True where it routes differently (the
    GIN halo entry, the kernel's segment sums of the halo neighbor sum)
    against the same JAX steps (in f32 the fused and unfused JAX models
    differ only in summation order, and the entries are held to the JAX
    entries above);
  * gin/kan in bf16 (fused, the flagship path) at the step bars: the loss
    within 4 bf16 ulps of its value, each gradient at the graph steps'
    bf16 gradient bars of its leaf's largest value (see the test);
  * the singleton specialisation against `force_full` (a one-rank
    subgroup) and the JAX singleton step, over 3 steps;
  * `initialize_multihost` from the environment names.

Values rtol 1e-4 / atol 1e-5, gradients rtol 1e-3 / atol 1e-5 (ROADMAP's
port conventions): the same f32 arithmetic summed in another order.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax import shard_map
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

from kagnn_tpu.dist import halo as jhalo
from kagnn_tpu.graphs import single_graph as jax_single_graph
from kagnn_tpu.models import NodeClassifier as JaxNodeClassifier
from kagnn_tpu.ops import segment as jsegment
from kagnn_tpu.pallas.gin_fastkan import gin_fastkan_fused_halo as jax_gfk_halo
from kagnn_tpu.pallas.gin_fused import gin_kan_fused_halo as jax_gk_halo
from kagnn_tpu.train import create_train_state
from kagnn_tpu_torch.data import community_node_graph
from kagnn_tpu_torch.dist import halo as thalo
from kagnn_tpu_torch.dist.launch import launch
from kagnn_tpu_torch.dist.runs import init_rank, many_rank, stitch_logits
from kagnn_tpu_torch.graphs import single_graph
from kagnn_tpu_torch.kan import FastKANLayer, KANLinear
from kagnn_tpu_torch.kernels.selfcheck import bf16_grad_ratios
from kagnn_tpu_torch.models import NodeClassifier
from kagnn_tpu_torch.utils.port import from_jax_variables

torch.set_num_threads(1)
pytestmark = pytest.mark.skipif(len(jax.devices()) < 8,
                                reason="needs 8 (virtual) devices")

D = 4
VAL = dict(rtol=1e-4, atol=1e-5)
GRAD = dict(rtol=1e-3, atol=1e-5)
BF16_ULP = 2.0 ** -8
KW = dict(mp_layers=2, num_features=6, hidden_channels=8, num_classes=3,
          skip=True, grid_size=4, dropout=0.0)
# {gin, gcn, gat} x {mlp, kan, fastkan} unfused; fused where the port routes
# differently: the GIN halo entry (gin/kan) and the kernel's segment sums of
# the halo neighbor sum (gin/fastkan, gcn/kan)
CONFIGS = ([(c, a, False) for c in ("gin", "gcn", "gat")
            for a in ("mlp", "kan", "fastkan")]
           + [("gin", "kan", True), ("gin", "fastkan", True), ("gcn", "kan", True)])
IDS = [f"{c}-{a}-{'fused' if f else 'plain'}" for c, a, f in CONFIGS]
BF16 = ("gin", "kan", True)
# the port's fused configurations, each held to the JAX step of its
# unfused configuration
PLAIN_CONFIGS = [c for c in CONFIGS if not c[2]]
# configurations whose evaluation after the step is compared
EVAL = {("gcn", "fastkan", False), ("gin", "kan", False)}
ENTRIES = ("kan", "fastkan")
EPS = 0.25
ENTRY_D, ENTRY_O = 6, 5


def _data(n=96, seed=5):
    return community_node_graph(n_nodes=n, n_classes=3, num_features=6, seed=seed)


def _arrays(d):
    return {k: d[k] for k in ("senders", "receivers", "nodes", "y", "n_node")}


@pytest.fixture(scope="module")
def graph():
    d = _data()
    gj = jax_single_graph(d["senders"], d["receivers"], nodes=d["nodes"],
                          y=d["y"], edge_pad_multiple=128)
    mask = np.zeros(gj.n_node_pad, bool)
    mask[:d["n_node"]] = d["masks"]["train"]
    return d, gj, mask


def _mesh(n):
    return Mesh(np.asarray(jax.devices()[:n]).reshape(n), ("graph",))


def _jax_model(conv, arch, fused, dtype=None):
    return JaxNodeClassifier(conv_type=conv, architecture=arch, fused=fused,
                             compute_dtype=dtype, **KW)


def _numpy(tree):
    return jax.tree.map(np.asarray, tree)


def _close_to_scale(got, want, rtol, atol, what=""):
    """|got - want| <= atol + rtol * max |want|: against the JAX f32 one-hot
    segment sums of the fused kernels, which carry the messages as bf16
    hi/lo pairs, the rtol applies to the output's scale (ROADMAP's port
    conventions)."""
    err = float(np.abs(np.asarray(got) - np.asarray(want)).max())
    assert err <= atol + rtol * float(np.abs(want).max()), (what, err)


def _jax_halo_step(gj, mask, conv, arch, fused, dtype=None, ev=False):
    """The JAX halo step with SGD(1): the initial variables, the loss, the
    gradients (p - p_new) in the port's names, and with `ev` the evaluation
    (loss, accuracy) after the step."""
    model = _jax_model(conv, arch, fused, dtype)
    tx = optax.sgd(1.0)
    state, _ = create_train_state(model, jax.random.key(0), gj, tx)
    plan = jhalo.build_halo_plan(gj, D)
    step, evaluate = jhalo.make_halo_node_step(model, tx, _mesh(D), plan, gj, mask)
    new, loss = step(state, jax.random.key(3))
    grads = jax.tree.map(lambda a, b: np.asarray(a, np.float32) - np.asarray(b, np.float32),
                         state.params, new.params)
    if ev:
        ev = tuple(float(v) for v in evaluate(new, np.asarray(gj.node_mask)))
    return (_numpy(state.variables()), float(loss),
            {k: v.numpy() for k, v in from_jax_variables({"params": grads}).items()},
            ev)


def _state_np(variables):
    return {k: v.numpy() for k, v in from_jax_variables(variables).items()}


def _node_spec(d, mask, conv, arch, fused, variables, dtype="float32", **kw):
    return dict(graph=_arrays(d), strategy="halo", device="cpu", opt=("sgd", 1.0),
                steps=1, mask=mask, state=_state_np(variables),
                model=dict(conv_type=conv, architecture=arch, fused=fused,
                           dtype=dtype, seed=0, **KW), **kw)


def _entry_weights(kind):
    """A layer's weights in the module layouts, from the port's init."""
    if kind == "kan":
        m = KANLinear(ENTRY_D, ENTRY_O, grid_size=4, spline_order=3,
                      generator=torch.Generator().manual_seed(7), device="cpu")
        return {"grid": m.grid.numpy(), "base_weight": m.base_weight.detach().numpy(),
                "scaled_spline_weight": m.scaled_spline_weight.detach().numpy()}
    m = FastKANLayer(ENTRY_D, ENTRY_O, num_grids=4,
                     generator=torch.Generator().manual_seed(7), device="cpu")
    with torch.no_grad():
        m.layernorm.weight.uniform_(0.5, 1.5, generator=torch.Generator().manual_seed(8))
        m.layernorm.bias.uniform_(-0.2, 0.2, generator=torch.Generator().manual_seed(9))
    return {"ln_scale": m.layernorm.weight.detach().numpy(),
            "ln_bias": m.layernorm.bias.detach().numpy(),
            "spline_weight": m.spline_linear.weight.detach().numpy(),
            "base_weight": m.base_linear.weight.detach().numpy(),
            "base_bias": m.base_linear.bias.detach().numpy()}


def _entry_inputs(n_pad):
    rng = np.random.default_rng(11)
    return (rng.normal(size=(n_pad, ENTRY_D)).astype(np.float32),
            rng.normal(size=(n_pad, ENTRY_O)).astype(np.float32))


@pytest.fixture(scope="module")
def jax_steps(graph):
    """The JAX halo step of every configuration, and the bf16 flagship's."""
    d, gj, mask = graph
    out = {cfg: _jax_halo_step(gj, mask, *cfg, ev=cfg in EVAL) for cfg in PLAIN_CONFIGS}
    out["bf16"] = _jax_halo_step(gj, mask, *BF16, dtype=jnp.bfloat16)
    return out


@pytest.fixture(scope="module")
def port_runs(graph, jax_steps, tmp_path_factory):
    """Every port configuration in one spawn of D gloo ranks: the halo steps,
    the bf16 flagship, the exchange, both halo entries in both dtypes, the
    force_full step on a one-rank subgroup and the evaluation."""
    d, gj, mask = graph
    jobs, names = [], []
    for conv, arch, fused in CONFIGS:
        jobs.append(("node", _node_spec(d, mask, conv, arch, fused,
                                        jax_steps[(conv, arch, False)][0],
                                        eval_mask=np.asarray(gj.node_mask))))
        names.append((conv, arch, fused))
    jobs.append(("node", _node_spec(d, mask, *BF16, jax_steps["bf16"][0], "bfloat16")))
    names.append("bf16")
    x, cot = _entry_inputs(gj.n_node_pad)
    jobs.append(("exchange", dict(graph=_arrays(d), x=x, seed=3)))
    names.append("exchange")
    for kind in ENTRIES:
        jobs.append(("entry", dict(graph=_arrays(d), x=x, cot=cot, kind=kind,
                                   weights=_entry_weights(kind), eps=EPS,
                                   spline_order=3, num_grids=4)))
        names.append(("entry", kind))
    ff = dict(_node_spec(d, mask, "gin", "fastkan", False, jax_steps[("gin", "fastkan", False)][0],
                         force_full=True, group_ranks=[0]), opt=("sgd", 1e-2), steps=3,
              eval_mask=np.asarray(gj.node_mask))
    jobs.append(("node", ff))
    names.append("force_full")
    res = launch(many_rank, D, (jobs,), backend="gloo", device="cpu", timeout=600,
                 threads=1, store_path=tmp_path_factory.mktemp("halo") / "store")
    return {name: [r[i] for r in res] for i, name in enumerate(names)}


def _graph_pair(kind):
    """(JAX graph, port graph) of a plan test: the community graph, a
    second seed, and a graph of 4 clusters with a few cross edges."""
    if kind == "clusters":
        rng = np.random.default_rng(0)
        n_per, snd, rcv = 80, [], []
        sizes = [80, 80, 80, 70]
        for c in range(4):
            a = rng.integers(c * n_per, c * n_per + sizes[c], 300)
            b = rng.integers(c * n_per, c * n_per + sizes[c], 300)
            snd += list(a) + list(b)
            rcv += list(b) + list(a)
        for c in range(3):
            a = rng.integers(c * n_per, c * n_per + 6, 6)
            b = rng.integers((c + 1) * n_per, (c + 1) * n_per + 6, 6)
            snd += list(a) + list(b)
            rcv += list(b) + list(a)
        n = 3 * n_per + sizes[-1]
        arrs = dict(senders=np.asarray(snd, np.int32), receivers=np.asarray(rcv, np.int32),
                    nodes=rng.normal(size=(n, 4)).astype(np.float32), y=np.zeros(n, np.int32))
    else:
        d = _data(80 if kind == "small" else 96, 7 if kind == "small" else 5)
        arrs = {k: d[k] for k in ("senders", "receivers", "nodes", "y")}
    return (jax_single_graph(**arrs, edge_pad_multiple=128),
            single_graph(**arrs, device="cpu"))


PLANS = [("small", 4, {}), ("base", 4, {}), ("base", 2, {}), ("base", 1, {}),
         ("base", 3, dict(split_edges=False)), ("clusters", 4, dict(block=80)),
         ("clusters", 4, dict(halo_multiple=16, edge_multiple=64))]


@pytest.mark.parametrize("kind,n,kw", PLANS,
                         ids=[f"{k}-{n}-{'-'.join(kw) or 'default'}" for k, n, kw in PLANS])
def test_plan_equals_jax(kind, n, kw):
    """Every field of the port's HaloPlan equals the JAX plan's."""
    gj, gt = _graph_pair(kind)
    a, b = jhalo.build_halo_plan(gj, n, **kw), thalo.build_halo_plan(gt, n, **kw)
    for f in ("n_shards", "block", "halo", "e_loc", "boundary_rows"):
        assert getattr(a, f) == getattr(b, f), f
    arrays = ("senders", "receivers", "edge_mask", "n_edge", "send_idx",
              "send_mask", "dinv_ext", "node_mask", "n_node", "senders_perm",
              "senders_sorted", "receivers_by_sender", "edge_mask_by_sender")
    for f in arrays + jhalo._SPLIT_FIELDS:
        va, vb = getattr(a, f), getattr(b, f)
        if va is None:
            assert vb is None, f
            continue
        assert va.dtype == vb.dtype and np.array_equal(va, vb), f
    assert thalo._SPLIT_FIELDS == jhalo._SPLIT_FIELDS
    assert a.comm_rows_per_device() == b.comm_rows_per_device()
    nodes = np.asarray(gj.nodes)
    assert np.array_equal(a.shard_nodes(nodes), b.shard_nodes(nodes))


def test_exchange_and_backward_replay_the_plan(graph, port_runs):
    """recv of rank d, block p, is x[p*B + send_idx[p, d]] where send_mask
    holds (zero elsewhere); the backward adds each rank's cotangent of block
    d back into rank d's sent rows (a row sent to several peers gathers
    several), exactly."""
    d, gj, _ = graph
    res = port_runs["exchange"]
    plan = thalo.build_halo_plan(single_graph(**{k: d[k] for k in (
        "senders", "receivers", "nodes", "y")}, device="cpu"), D)
    x, _ = _entry_inputs(gj.n_node_pad)
    xs = plan.shard_nodes(x)
    B, H = plan.block, plan.halo
    for r in range(D):
        want = np.zeros((D * H, ENTRY_D), np.float32)
        for p in range(D):
            rows = plan.send_idx[p, r][plan.send_mask[p, r]]
            want[p * H:p * H + rows.size] = xs[p][rows]
        np.testing.assert_array_equal(res[r]["recv"], want)
        dx = np.zeros((B, ENTRY_D), np.float64)
        for p in range(D):
            keep = plan.send_mask[r, p]
            np.add.at(dx, plan.send_idx[r, p][keep], res[p]["cot"][r * H:(r + 1) * H][keep])
        np.testing.assert_allclose(res[r]["dx"], dx, rtol=1e-6, atol=1e-6)
    assert plan.boundary_rows > 0


def _jax_entry(gj, kind):
    """The JAX halo entry under shard_map on D devices: each shard's output,
    the gradient of x of sum(out * cot) over all shards, and the weight
    gradients summed over the shards."""
    plan = jhalo.build_halo_plan(gj, D)
    mask = np.asarray(gj.node_mask)
    arrs = jhalo._stack_arrays(plan, gj, mask)
    x, cot = _entry_inputs(gj.n_node_pad)
    xs = jnp.asarray(plan.shard_nodes(x))
    cs = jnp.asarray(plan.shard_nodes(cot))
    w = {k: jnp.asarray(v) for k, v in _entry_weights(kind).items()}
    grid = w.pop("grid", None)

    def body(loc, x, cot, w):
        loc = {k: v[0] for k, v in loc.items()}
        x, cot = x[0], cot[0]
        g_loc, hs = jhalo._local_graph_and_state(plan, loc, "graph")

        def f(x, w):
            with jsegment.halo_mode(hs):
                if kind == "kan":
                    out = jax_gk_halo(x, g_loc, EPS, grid, w["base_weight"],
                                      w["scaled_spline_weight"], 3)
                else:
                    out = jax_gfk_halo(x, g_loc, EPS, w["ln_scale"], w["ln_bias"],
                                       w["spline_weight"], w["base_weight"],
                                       w["base_bias"], -2.0, 2.0, 4, 4.0 / 3.0)
            return (out.astype(jnp.float32) * cot).sum(), out

        (_, out), (dx, dw) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(x, w)
        dw = jax.tree.map(lambda a: jax.lax.psum(a.astype(jnp.float32), "graph"), dw)
        return out[None], dx[None], dw

    fn = jax.jit(shard_map(body, mesh=_mesh(D),
                           in_specs=({k: P("graph") for k in arrs}, P("graph"),
                                     P("graph"), P()),
                           out_specs=(P("graph"), P("graph"), P()), check_vma=False))
    out, dx, dw = fn(arrs, xs, cs, w)
    return (np.asarray(out, np.float32), np.asarray(dx, np.float32),
            {k: np.asarray(v) for k, v in dw.items()})


@pytest.mark.parametrize("kind", ENTRIES)
def test_halo_entry_matches_jax(graph, port_runs, kind):
    """Output, dx and the weight gradients of the port's halo entry against
    the JAX entry's on every shard (shard 3 holds only padding rows, the
    others padded edges pointing at their valid row B-1), f32: the values
    at the f32 value bar, the gradients at the gradient bar, of the
    output's scale."""
    d, gj, _ = graph
    out, dx, dw = _jax_entry(gj, kind)
    res = port_runs[("entry", kind)]
    _close_to_scale(np.stack([r["out"] for r in res]), out, **VAL, what="out")
    _close_to_scale(np.stack([r["dx"] for r in res]), dx, **GRAD, what="dx")
    for k, v in dw.items():
        _close_to_scale(res[0]["dw"][k], v, **GRAD, what=k)
        assert all(np.array_equal(r["dw"][k], res[0]["dw"][k]) for r in res)


@pytest.mark.parametrize("cfg", CONFIGS, ids=IDS)
def test_halo_step_matches_jax(graph, jax_steps, port_runs, cfg):
    """The port's halo step against the JAX halo step (unfused) from the
    same weights: the loss, every gradient leaf, the evaluation after the
    step where the JAX side took it, and the parameters equal on every
    rank."""
    _, loss, grads, ev = jax_steps[cfg[:2] + (False,)]
    res = port_runs[cfg]
    np.testing.assert_allclose(res[0]["losses"][0], loss, **VAL)
    assert set(res[0]["grads"]) == set(grads)
    for k, v in grads.items():
        np.testing.assert_allclose(res[0]["grads"][k], v, **GRAD, err_msg=k)
    if ev:
        np.testing.assert_allclose(res[0]["eval"], ev, **VAL)
    assert all(np.array_equal(r["params"], res[0]["params"]) for r in res)


def test_bf16_halo_step_matches_jax(jax_steps, port_runs):
    """gin/kan fused in bf16, the flagship path, against the JAX bf16 halo
    step: the loss within 4 bf16 ulps of its value; each gradient leaf at
    the bf16 gradient bars of the graph steps (`selfcheck.bf16_grad_ratios`,
    tests/test_torch_graph_steps.py), at the leaf's largest value: within 8
    ulps of the JAX bf16 gradient plus that gradient's own distance from the
    JAX f32 one (capped at 14 ulps), and no farther from the f32 gradient
    than the JAX bf16 gradient is, plus 8 ulps. The halo step sums each
    weight gradient as D shards' bf16 walks over their own row tiles, and
    the exchange's backward adds the halo rows' bf16 cotangents to their
    owners', so both models round in places the single-card step does not."""
    variables, loss, grads, _ = jax_steps["bf16"]
    exact = jax_steps[("gin", "kan", False)]
    assert jax.tree.all(jax.tree.map(np.array_equal, variables["params"], exact[0]["params"]))
    res = port_runs["bf16"]
    assert abs(res[0]["losses"][0] - loss) <= 4 * BF16_ULP * abs(loss)
    worst = (0.0, 0.0)
    for k, v in grads.items():
        r = bf16_grad_ratios(res[0]["grads"][k], v, exact[2][k], float(np.abs(v).max()))
        assert max(r) <= 1.0, (k, r)
        worst = tuple(max(a, b) for a, b in zip(worst, r))
    print(f"bf16 halo step: worst gradient ratios {worst[0]:.3f} / {worst[1]:.3f}")
    assert all(np.array_equal(r["params"], res[0]["params"]) for r in res)


def test_singleton_and_force_full_match_jax(graph, jax_steps, port_runs):
    """One shard: the port's singleton step (no group, the input batch as
    it is) and its full machinery (force_full, a one-rank group) against
    the JAX singleton step, 3 SGD steps' losses and the evaluation."""
    d, gj, mask = graph
    variables = jax_steps[("gin", "fastkan", False)][0]
    model = _jax_model("gin", "fastkan", False)
    tx = optax.sgd(1e-2)
    state, _ = create_train_state(model, jax.random.key(0), gj, tx)
    state = state.replace(params=variables["params"])
    plan = jhalo.build_halo_plan(gj, 1)
    assert plan.boundary_rows == 0
    step, evaluate = jhalo.make_halo_node_step(model, tx, _mesh(1), plan, gj, mask)
    want = []
    for _ in range(3):
        state, loss = step(state, jax.random.key(3))
        want.append(float(loss))
    ev = [float(v) for v in evaluate(state, np.asarray(gj.node_mask))]

    gt = single_graph(**{k: d[k] for k in ("senders", "receivers", "nodes", "y")},
                      device="cpu")
    m = NodeClassifier(conv_type="gin", architecture="fastkan", seed=0, device="cpu", **KW)
    m.load_state_dict(from_jax_variables(variables))
    opt = torch.optim.SGD(m.parameters(), lr=1e-2)
    tstep, tevaluate = thalo.make_halo_node_step(m, opt, thalo.build_halo_plan(gt, 1), gt, mask)
    got = [float(tstep()) for _ in range(3)]
    np.testing.assert_allclose(got, want, **VAL)
    np.testing.assert_allclose([float(v) for v in tevaluate(np.asarray(gj.node_mask))], ev, **VAL)
    full = port_runs["force_full"][0]
    np.testing.assert_allclose(full["losses"], want, **VAL)
    np.testing.assert_allclose(full["eval"], ev, **VAL)
    assert all(r is None for r in port_runs["force_full"][1:])


def test_logits_stitch_to_the_single_graph(graph, jax_steps, port_runs):
    """The shards' logits of the first forward, in global row order, are
    the unsharded model's (gcn/fastkan, f32, train mode)."""
    d, gj, _ = graph
    res = port_runs[("gcn", "fastkan", False)]
    gt = single_graph(**{k: d[k] for k in ("senders", "receivers", "nodes", "y")},
                      device="cpu")
    m = NodeClassifier(conv_type="gcn", architecture="fastkan", seed=0, device="cpu", **KW)
    m.load_state_dict(from_jax_variables(jax_steps[("gcn", "fastkan", False)][0]))
    m.train()
    with torch.no_grad():
        want = m(gt).numpy()
    nm = np.asarray(gj.node_mask)
    np.testing.assert_allclose(stitch_logits(res, gt.n_node_pad)[nm], want[nm], **VAL)


def test_initialize_multihost_from_the_environment(tmp_path):
    """initialize_multihost is a no-op while a group exists; with the JAX
    module's environment names (COORDINATOR_ADDRESS as a file:// store,
    NUM_PROCESSES, PROCESS_ID) it makes the group: 2 ranks all-reduce their
    ids."""
    env = {"COORDINATOR_ADDRESS": f"file://{tmp_path / 'init_store'}",
           "NUM_PROCESSES": "2"}
    res = launch(init_rank, 2, (dict(env=env),), backend="gloo", device="cpu",
                 timeout=120, threads=1, store_path=tmp_path / "store")
    assert [r["kept"] for r in res] == [True, True]
    assert [(r["world"], r["rank"], r["total"]) for r in res] == [(2, 0, 1.0), (2, 1, 1.0)]
