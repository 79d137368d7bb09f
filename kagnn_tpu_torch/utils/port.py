"""Weight carrier between the JAX `NodeClassifier` variable tree and the
port's `NodeClassifier` state_dict (gin, gcn and gat convs, mlp, kan and fastkan
architectures). Works on numpy arrays: the JAX tree's leaves come in as
numpy (`jax.tree.map(np.asarray, v)`), and nothing here imports jax.

Modules:
    {params,buffers}/KAN_{i}/layers_{j}/...      <-> convs.{i}.update.layers.{j}....
    params/FastKAN_{i}/layers_{j}/...            <-> convs.{i}.update.layers.{j}....
    params/MLP_{i}/TorchLinear_{j}/{kernel,bias} <-> convs.{i}.update.layers.{j}.{weight,bias}
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


def _module(mod: str, rest: tuple, head_kind: str):
    """JAX module name and the path below it -> (torch prefix, path below
    the layer, the layer's kind)."""
    if mod == "head":
        return "head", rest, head_kind
    if m := re.fullmatch(r"(Fast)?KAN_(\d+)", mod):
        layer = re.fullmatch(r"layers_(\d+)", rest[0]).group(1)
        return (f"convs.{m.group(2)}.update.layers.{layer}", rest[1:],
                FAST if m.group(1) else KAN)
    if m := re.fullmatch(r"MLP_(\d+)", mod):
        layer = re.fullmatch(r"TorchLinear_(\d+)", rest[0]).group(1)
        return f"convs.{m.group(1)}.update.layers.{layer}", rest[1:], LINEAR
    if m := re.fullmatch(r"G(?:CN|AT)Conv_(\d+)", mod):
        if rest in (("bias",), ("att_src",), ("att_dst",)):
            return f"convs.{m.group(1)}", rest, KAN
        t = re.fullmatch(r"(FastKANLayer|KANLinear|Dense)_0", rest[0])
        if t is not None:
            return f"convs.{m.group(1)}.transform", rest[1:], _TRANSFORM[t.group(1)]
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


def from_jax_variables(variables: Mapping) -> dict[str, torch.Tensor]:
    """JAX NodeClassifier variables -> the port's state_dict."""
    head_kind = _head_kind(variables.get("params", {}).get("head", {}))
    sd = {}
    for path, v in _leaves(variables):
        coll, mod, rest = path[0], path[1], path[2:]
        transpose = False
        if m := re.fullmatch(r"MaskedBatchNorm_(\d+)", mod):
            key = f"norms.{m.group(1)}.{_BN[(coll, rest[0])]}"
        elif (found := _module(mod, rest, head_kind)) is not None:
            prefix, leaf, kind = found
            key = f"{prefix}.{_torch_leaf(kind, leaf)}"
            transpose = kind == LINEAR and leaf == ("kernel",)
        else:
            raise KeyError(f"no port counterpart for {'/'.join(path)}")
        sd[key] = _to_torch(v, transpose)
    return sd


def to_jax_variables(state_dict: Mapping[str, Any]) -> dict:
    """The port's state_dict -> JAX NodeClassifier variables (numpy)."""
    inv_bn = {v: k for k, v in _BN.items()}
    gat = {k.split(".")[1] for k in state_dict
           if k.startswith("convs.") and k.endswith(".att_src")}
    out: dict = {}

    def conv(i: str) -> str:
        return f"{'GATConv' if i in gat else 'GCNConv'}_{i}"

    def put(path, value):
        d = out
        for p in path[:-1]:
            d = d.setdefault(p, {})
        d[path[-1]] = _np(value).T if path[-1] == "kernel" else _np(value)

    def leaf(rest: str):
        """Torch name below a layer -> (collection, kind, JAX path)."""
        if rest in _FAST_INV:
            return "params", FAST, _FAST_INV[rest]
        if rest in _LINEAR_INV:
            return "params", LINEAR, _LINEAR_INV[rest]
        return ("buffers" if rest == "grid" else "params"), KAN, (rest,)

    for key, v in state_dict.items():
        parts = key.split(".")
        if parts[0] == "norms":
            coll, name = inv_bn[parts[2]]
            put((coll, f"MaskedBatchNorm_{parts[1]}", name), v)
            continue
        if parts[0] == "head":
            coll, _, path = leaf(".".join(parts[1:]))
            put((coll, "head", *path), v)
            continue
        if parts[0] == "convs" and len(parts) == 3 and parts[2] != "update":
            put(("params", conv(parts[1]), parts[2]), v)
            continue
        if parts[0] == "convs" and parts[2] == "update":
            coll, kind, path = leaf(".".join(parts[5:]))
            mod, layer = {KAN: ("KAN", "layers"), FAST: ("FastKAN", "layers"),
                          LINEAR: ("MLP", "TorchLinear")}[kind]
            put((coll, f"{mod}_{parts[1]}", f"{layer}_{parts[4]}", *path), v)
            continue
        if parts[0] == "convs" and parts[2] == "transform":
            coll, kind, path = leaf(".".join(parts[3:]))
            layer = {KAN: "KANLinear_0", FAST: "FastKANLayer_0",
                     LINEAR: "Dense_0"}[kind]
            put((coll, conv(parts[1]), layer, *path), v)
            continue
        raise KeyError(f"no JAX counterpart for {key}")
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
