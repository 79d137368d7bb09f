"""Weight carrier between the JAX variable trees of `NodeClassifier`,
`GraphClassifier` and `GraphRegressor` and the port models' state_dicts
(gin, gcn and gat convs, GINE; mlp, kan and fastkan architectures). Works on
numpy arrays: the JAX tree's leaves come in as numpy
(`jax.tree.map(np.asarray, v)`), and nothing here imports jax.

Modules:
    {params,buffers}/KAN_{i}/layers_{j}/...      <-> convs.{i}.update.layers.{j}....
    params/FastKAN_{i}/layers_{j}/...            <-> convs.{i}.update.layers.{j}....
    params/MLP_{i}/TorchLinear_{j}/{kernel,bias} <-> convs.{i}.update.layers.{j}.{weight,bias}
    {params,batch_stats}/MLP_{i}/MaskedBatchNorm_{k}/... <-> convs.{i}.update.norms.{k}....
    {params,buffers}/GCNConv_{i}/KANLinear_0/... <-> convs.{i}.transform....
    params/GCNConv_{i}/FastKANLayer_0/...        <-> convs.{i}.transform....
    params/GCNConv_{i}/Dense_0/kernel            <-> convs.{i}.transform.weight
    params/GCNConv_{i}/bias                      <-> convs.{i}.bias
    {params,buffers}/GATConv_{i}/KANLinear_0/... <-> convs.{i}.transform....
    params/GATConv_{i}/FastKANLayer_0/...        <-> convs.{i}.transform....
    params/GATConv_{i}/Dense_0/kernel            <-> convs.{i}.transform.weight
    params/GATConv_{i}/{att_src,att_dst,bias}    <-> convs.{i}.{att_src,att_dst,bias}
    params/MaskedBatchNorm_{i}/{scale,bias}      <-> norms.{i}.{weight,bias}
    batch_stats/MaskedBatchNorm_{i}/{mean,var}   <-> norms.{i}.{running_mean,running_var}
    {params,buffers}/head/...                    <-> head....
    params/AtomEncoder_0/CategoricalSumEncoder_0/emb_{k} <-> atom_encoder.emb.{k}
    params/BondEncoder_0/CategoricalSumEncoder_0/emb_{k} <-> bond_encoder.emb.{k}
    params/{atom,bond}_encoder/{kernel,bias}     <-> {atom,bond}_encoder.{weight,bias}

A node model's head is the module `head`. Flax names a graph model's nets by
position instead: a GIN model's update nets are KAN_0..KAN_{L-1} (or
FastKAN_i, MLP_i) and its head net KAN_L; a GCN or GAT model's only net,
KAN_0, is its head; the head net maps to `head.layers.{j}....` (the port's
graph heads are nets). Embedding tables keep their (vocab, emb) layout.
Leaves of a KANLinear keep their names (base_weight, spline_weight,
spline_scaler, the buffer grid); those of a FastKANLayer map as
    spline_weight <-> spline_linear.weight, base_weight <-> base_linear.weight,
    base_bias <-> base_linear.bias, layernorm/{scale,bias} <-> layernorm.{weight,bias}.

and those of a linear (an MLP's TorchLinear, a Dense transform, an mlp
head) as kernel <-> weight, bias <-> bias.

The KAN layouts are the same on both sides (the JAX layers keep the torch
layouts), so those arrays pass through unchanged; a linear's kernel is
(in, out) in JAX and its weight (out, in) in torch, so it is transposed.

`fastkan_from_jax` / `fastkan_to_jax` carry a bare `FastKAN` or
`FastKANLayer` (params/layers_{i}/... or the layer's own leaves), whose
layernorm and base leaves may be missing (the layer's flags off), as the JAX
side's `port_fastkan_layer(use_layernorm, use_base_update)` lays them out.
"""
from __future__ import annotations

import re
from typing import Any, Mapping

import numpy as np
import torch

_BN = {("params", "scale"): "weight", ("params", "bias"): "bias",
       ("batch_stats", "mean"): "running_mean",
       ("batch_stats", "var"): "running_var"}
_FAST = {("spline_weight",): "spline_linear.weight",
         ("base_weight",): "base_linear.weight",
         ("base_bias",): "base_linear.bias",
         ("layernorm", "scale"): "layernorm.weight",
         ("layernorm", "bias"): "layernorm.bias"}
_FAST_INV = {v: k for k, v in _FAST.items()}
_LINEAR = {("kernel",): "weight", ("bias",): "bias"}
_LINEAR_INV = {v: k for k, v in _LINEAR.items()}


def _np(v: Any) -> np.ndarray:
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _leaves(tree: Mapping, prefix=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


# the kinds of layer a leaf can sit in: its names map through _FAST
# (FastKANLayer), _LINEAR (a linear, kernel transposed) or as they are
# (KANLinear, and a conv's own leaves)
KAN, FAST, LINEAR = "kan", "fast", "linear"
_TRANSFORM = {"KANLinear": KAN, "FastKANLayer": FAST, "Dense": LINEAR}


_NET = re.compile(r"(FastKAN|KAN|MLP)_(\d+)")
_NET_KIND = {"KAN": KAN, "FastKAN": FAST, "MLP": LINEAR}
_NET_NAMES = {KAN: ("KAN", "layers"), FAST: ("FastKAN", "layers"),
              LINEAR: ("MLP", "TorchLinear")}
_ENCODERS = {"AtomEncoder_0": "atom_encoder", "BondEncoder_0": "bond_encoder"}


def _net_leaf(prefix: str, kind: str, rest: tuple):
    """A leaf below a KAN, FastKAN or MLP net -> (torch key, transpose)."""
    if m := re.fullmatch(r"(?:layers|TorchLinear)_(\d+)", rest[0]):
        leaf = rest[1:]
        return (f"{prefix}.layers.{m.group(1)}.{_torch_leaf(kind, leaf)}",
                kind == LINEAR and leaf == ("kernel",))
    return None


def _module(coll: str, mod: str, rest: tuple, head_kind: str,
            head_net: int | None):
    """JAX module name and the path below it -> (torch key, transpose), or
    None. `head_net` is the index of the graph model's net that is its head
    (None for a node model, whose head is the module `head`)."""
    if m := re.fullmatch(r"MaskedBatchNorm_(\d+)", mod):
        return f"norms.{m.group(1)}.{_BN[(coll, rest[0])]}", False
    if mod == "head":
        return f"head.{_torch_leaf(head_kind, rest)}", (
            head_kind == LINEAR and rest == ("kernel",))
    if m := _NET.fullmatch(mod):
        i = int(m.group(2))
        prefix = "head" if i == head_net else f"convs.{i}.update"
        if b := re.fullmatch(r"MaskedBatchNorm_(\d+)", rest[0]):
            return f"{prefix}.norms.{b.group(1)}.{_BN[(coll, rest[1])]}", False
        return _net_leaf(prefix, _NET_KIND[m.group(1)], rest)
    if m := re.fullmatch(r"G(?:CN|AT)Conv_(\d+)", mod):
        if rest in (("bias",), ("att_src",), ("att_dst",)):
            return f"convs.{m.group(1)}.{rest[0]}", False
        t = re.fullmatch(r"(FastKANLayer|KANLinear|Dense)_0", rest[0])
        if t is not None:
            kind = _TRANSFORM[t.group(1)]
            return (f"convs.{m.group(1)}.transform.{_torch_leaf(kind, rest[1:])}",
                    kind == LINEAR and rest[1:] == ("kernel",))
    if mod in _ENCODERS and (e := re.fullmatch(r"emb_(\d+)", rest[-1])):
        return f"{_ENCODERS[mod]}.emb.{e.group(1)}", False
    if mod in ("atom_encoder", "bond_encoder"):
        return f"{mod}.{_LINEAR[rest]}", rest == ("kernel",)
    return None


def _head_kind(tree: Mapping) -> str:
    """A FastKANLayer's spline weight is (O, D*G), a KANLinear's 3-D; a
    TorchLinear has a kernel."""
    if "kernel" in tree:
        return LINEAR
    fast = "spline_weight" in tree and np.ndim(tree["spline_weight"]) == 2
    return FAST if fast else KAN


def _torch_leaf(kind: str, leaf: tuple) -> str:
    return {FAST: _FAST, LINEAR: _LINEAR}[kind][leaf] if kind != KAN else ".".join(leaf)


def _to_torch(v: Any, transpose: bool) -> torch.Tensor:
    a = np.array(_np(v), dtype=np.float32)
    return torch.from_numpy(np.ascontiguousarray(a.T) if transpose else a)


def _graph_head_net(params: Mapping) -> int | None:
    """The index of a graph model's head net: GCN and GAT models have one
    net, their head (the convs hold transforms); a GIN model's head comes
    after its update nets. None for a node model (its head is `head`)."""
    if "head" in params:
        return None
    nets = [int(m.group(2)) for k in params if (m := _NET.fullmatch(k))]
    if any(re.fullmatch(r"G(?:CN|AT)Conv_\d+", k) for k in params):
        return 0
    return max(nets, default=None)


def from_jax_variables(variables: Mapping) -> dict[str, torch.Tensor]:
    """JAX NodeClassifier, GraphClassifier or GraphRegressor variables ->
    the port model's state_dict."""
    params = variables.get("params", {})
    head_kind = _head_kind(params.get("head", {}))
    head_net = _graph_head_net(params)
    sd = {}
    for path, v in _leaves(variables):
        found = _module(path[0], path[1], path[2:], head_kind, head_net)
        if found is None:
            raise KeyError(f"no port counterpart for {'/'.join(path)}")
        key, transpose = found
        sd[key] = _to_torch(v, transpose)
    return sd


def jax_paths(state_dict: Mapping[str, Any]) -> dict[str, tuple]:
    """Each key of the port model's state_dict -> the path of its leaf in
    the JAX variables (collection first: ("buffers", "KAN_0", "layers_1",
    "grid"))."""
    inv_bn = {v: k for k, v in _BN.items()}
    convs = {k.split(".")[1] for k in state_dict if k.startswith("convs.")}
    gat = {k.split(".")[1] for k in state_dict
           if k.startswith("convs.") and k.endswith(".att_src")}
    graph = any(k.startswith(("head.layers.", "head.norms.")) for k in state_dict)
    transforms = any(k.split(".")[2] in ("transform", "bias")
                     for k in state_dict if k.startswith("convs."))
    head_net = str(0 if transforms else len(convs))
    out: dict = {}

    def conv(i: str) -> str:
        return f"{'GATConv' if i in gat else 'GCNConv'}_{i}"

    def leaf(rest: str):
        """Torch name below a layer -> (collection, kind, JAX path)."""
        if rest in _FAST_INV:
            return "params", FAST, _FAST_INV[rest]
        if rest in _LINEAR_INV:
            return "params", LINEAR, _LINEAR_INV[rest]
        return ("buffers" if rest == "grid" else "params"), KAN, (rest,)

    def net(i: str, parts: list):
        """parts below a net: layers.{j}.<leaf> or norms.{k}.<leaf>."""
        if parts[0] == "norms":
            coll, name = inv_bn[parts[2]]
            return (coll, f"MLP_{i}", f"MaskedBatchNorm_{parts[1]}", name)
        coll, kind, path = leaf(".".join(parts[2:]))
        mod, layer = _NET_NAMES[kind]
        return (coll, f"{mod}_{i}", f"{layer}_{parts[1]}", *path)

    for key in state_dict:
        parts = key.split(".")
        if parts[0] == "norms":
            coll, name = inv_bn[parts[2]]
            out[key] = (coll, f"MaskedBatchNorm_{parts[1]}", name)
        elif parts[0] == "head" and graph:
            out[key] = net(head_net, parts[1:])
        elif parts[0] == "head":
            coll, _, path = leaf(".".join(parts[1:]))
            out[key] = (coll, "head", *path)
        elif parts[0] in ("atom_encoder", "bond_encoder") and parts[1] == "emb":
            mod = {v: k for k, v in _ENCODERS.items()}[parts[0]]
            out[key] = ("params", mod, "CategoricalSumEncoder_0", f"emb_{parts[2]}")
        elif parts[0] in ("atom_encoder", "bond_encoder"):
            out[key] = ("params", parts[0], *_LINEAR_INV[parts[1]])
        elif parts[0] == "convs" and len(parts) == 3:
            out[key] = ("params", conv(parts[1]), parts[2])
        elif parts[0] == "convs" and parts[2] == "update":
            out[key] = net(parts[1], parts[3:])
        elif parts[0] == "convs" and parts[2] == "transform":
            coll, kind, path = leaf(".".join(parts[3:]))
            layer = {KAN: "KANLinear_0", FAST: "FastKANLayer_0",
                     LINEAR: "Dense_0"}[kind]
            out[key] = (coll, conv(parts[1]), layer, *path)
        else:
            raise KeyError(f"no JAX counterpart for {key}")
    return out


def to_jax_variables(state_dict: Mapping[str, Any]) -> dict:
    """The port model's state_dict -> JAX variables (numpy)."""
    out: dict = {}
    for key, path in jax_paths(state_dict).items():
        d = out
        for p in path[:-1]:
            d = d.setdefault(p, {})
        v = _np(state_dict[key])
        d[path[-1]] = v.T if path[-1] == "kernel" else v
    return out


def fastkan_from_jax(variables: Mapping) -> dict[str, torch.Tensor]:
    """JAX FastKAN ({"params": {"layers_{i}": ...}}) or FastKANLayer
    ({"params": {leaves}}) variables -> the port module's state_dict."""
    sd = {}
    for path, v in _leaves(variables["params"]):
        layer = re.fullmatch(r"layers_(\d+)", path[0])
        prefix, leaf = ((f"layers.{layer.group(1)}.", path[1:]) if layer
                        else ("", path))
        sd[prefix + _FAST[leaf]] = torch.from_numpy(np.array(_np(v), dtype=np.float32))
    return sd


def fastkan_to_jax(state_dict: Mapping[str, Any]) -> dict:
    """The port's FastKAN or FastKANLayer state_dict -> JAX variables
    (numpy)."""
    params: dict = {}
    for key, v in state_dict.items():
        layer = re.fullmatch(r"layers\.(\d+)\.(.+)", key)
        d = params.setdefault(f"layers_{layer.group(1)}", {}) if layer else params
        *path, name = _FAST_INV[layer.group(2) if layer else key]
        for p in path:
            d = d.setdefault(p, {})
        d[name] = _np(v)
    return {"params": params}
