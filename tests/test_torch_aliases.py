"""The port's reference-named constructors (`kagnn_tpu_torch/nn/kagnn.py`)
against the JAX package's (`kagnn_tpu/nn/kagnn.py`), the counterpart of
tests/test_aliases.py: each of the ten aliases built with the same
arguments holds the same modules (the JAX variables carry into its
state_dict key for key, shape for shape) and computes the same output on
the same weights, unfused and fused (on the CPU the fused port runs its
kernels' plain versions, the JAX side its Pallas kernels in interpret
mode); and each equals its compositional counterpart in the port.

Tolerance: f32 rtol 1e-4 / atol 1e-5 of the output's scale (the fused JAX
segment sums carry f32 messages as bf16 hi/lo pairs)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kagnn_tpu import nn as jnn
from kagnn_tpu.graphs import single_graph as jax_single_graph
from kagnn_tpu_torch import nn as tnn
from kagnn_tpu_torch.graphs import single_graph

torch.set_num_threads(1)
VAL = dict(rtol=1e-4, atol=1e-5)
_FAST = {"spline_weight": "spline_linear.weight", "base_weight": "base_linear.weight",
         "base_bias": "base_linear.bias", "layernorm.scale": "layernorm.weight",
         "layernorm.bias": "layernorm.bias"}


def _state_dict(variables, fast: bool) -> dict:
    """A JAX conv's or net's variables -> the port module's state_dict: the
    transform (KANLinear_0 / FastKANLayer_0) is `transform`, a net's
    layers_i `layers.i`, an MLP's TorchLinear_i `layers.i` (kernel
    transposed), FastKAN leaves by the reference's names."""
    sd = {}
    for coll in ("params", "buffers"):
        for path, v in jax.tree_util.tree_flatten_with_path(variables.get(coll, {}))[0]:
            keys = [p.key for p in path]
            mods = []
            while keys and keys[0] not in ("base_weight", "spline_weight", "spline_scaler",
                                           "grid", "base_bias", "layernorm", "kernel",
                                           "bias", "att_src", "att_dst"):
                k = keys.pop(0)
                mods.append("transform" if k in ("KANLinear_0", "FastKANLayer_0") else
                            k.replace("layers_", "layers.").replace("TorchLinear_", "layers."))
            leaf = ".".join(keys)
            a = np.array(v, np.float32)
            if leaf == "kernel":
                leaf, a = "weight", a.T.copy()
            elif fast and mods and leaf in _FAST:
                leaf = _FAST[leaf]
            sd[".".join(mods + [leaf])] = torch.from_numpy(a)
    return sd


def _graphs(rng, n=12, e=40, f=5):
    snd, rcv = rng.integers(0, n, e), rng.integers(0, n, e)
    nodes = rng.normal(size=(n, f)).astype(np.float32)
    return (jax_single_graph(snd, rcv, nodes=nodes),
            single_graph(snd, rcv, nodes=nodes, device="cpu"))


ALIASES = {
    "KAGCNConv": ((5, 3), dict(grid_size=4, spline_order=2), "conv"),
    "KAGATConv": ((5, 3, 2), dict(grid_size=3, spline_order=3), "conv"),
    "GIKANLayer": ((5, 3), dict(grid_size=4, spline_order=2, hidden_dim=6), "conv"),
    "FASTKAGCNConv": ((5, 3), dict(grid_size=4), "conv"),
    "FASTKAGATConv": ((5, 3, 2), dict(grid_size=5), "conv"),
    "GIFASTKANLayer": ((5, 3), dict(grid_size=4, hidden_dim=6, nb_layers=3), "conv"),
    "KAGINEConv": ((5, 2), dict(grid_size=4, spline_order=3), "gine"),
    "make_mlp": ((5, 4, 3, 3), {}, "net"),
    "make_kan": ((5, 4, 3, 3), dict(grid_size=4, spline_order=2), "net"),
    "make_fastkan": ((5, 4, 3, 2), dict(grid_size=6), "net"),
}


# make_mlp takes no fused flag: neither side has a kernel for it
CASES = [(n, f) for n in sorted(ALIASES) for f in (False, True)
         if not (n == "make_mlp" and f)]


@pytest.mark.parametrize("name,fused", CASES,
                         ids=[f"{n}-{'fused' if f else 'unfused'}" for n, f in CASES])
def test_alias_matches_jax(rng, name, fused):
    args, kw, kind = ALIASES[name]
    if name != "make_mlp":
        kw = dict(kw, fused=fused)
    jm = getattr(jnn, name)(*args, **kw)
    tm = getattr(tnn, name)(*args, device="cpu", **kw)
    gj, gt = _graphs(rng)
    if kind == "conv":
        jargs, targs = (gj, gj.nodes), (gt, gt.nodes)
    elif kind == "gine":
        ea = rng.normal(size=(gt.n_edge_pad, 5)).astype(np.float32)
        jargs, targs = (gj, gj.nodes, jnp.asarray(ea)), (gt, gt.nodes, torch.from_numpy(ea))
    else:
        x = rng.normal(size=(9, 5)).astype(np.float32)
        jargs, targs = (jnp.asarray(x),), (torch.from_numpy(x),)
    variables = jm.init(jax.random.key(7), *jargs)
    sd = _state_dict(variables, fast="FAST" in name or name == "make_fastkan")
    assert set(sd) == set(tm.state_dict())
    tm.load_state_dict(sd)
    want = np.asarray(jm.apply(variables, *jargs), np.float32)
    got = tm(*targs).detach().numpy()
    rows = np.asarray(gj.node_mask) if kind != "net" else slice(None)
    tol = VAL["rtol"] * float(np.abs(want[rows]).max()) + VAL["atol"]
    assert float(np.abs(got[rows] - want[rows]).max()) <= tol


def test_aliases_equal_their_compositions(rng):
    """As tests/test_aliases.py holds the JAX aliases: KAGCNConv is GCNConv
    over kan_transform, make_kan the KAN of its sizes (three layers: 6->8,
    8->8, 8->3), bit for bit on the same generator."""
    _, g = _graphs(rng)
    a = tnn.KAGCNConv(5, 3, grid_size=4, spline_order=2, device="cpu",
                      generator=torch.Generator().manual_seed(1))
    b = tnn.GCNConv(5, 3, transform=tnn.kan_transform(
        4, 2, device="cpu", generator=torch.Generator().manual_seed(1)), device="cpu")
    b.load_state_dict(a.state_dict())
    assert torch.equal(a(g, g.nodes), b(g, g.nodes))
    m = tnn.make_kan(6, 8, 3, hidden_layers=3, grid_size=4, spline_order=2, device="cpu")
    assert [l.base_weight.shape for l in m.layers] == [(8, 6), (8, 8), (3, 8)]
