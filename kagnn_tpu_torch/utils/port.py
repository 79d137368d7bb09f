"""Weight carrier between the JAX `NodeClassifier` variable tree and the
port's `NodeClassifier` state_dict (gin, gcn and gat convs, kan and fastkan
architectures). Works on numpy arrays: the JAX tree's leaves come in as
numpy (`jax.tree.map(np.asarray, v)`), and nothing here imports jax.

Modules:
    {params,buffers}/KAN_{i}/layers_{j}/...      <-> convs.{i}.update.layers.{j}....
    params/FastKAN_{i}/layers_{j}/...            <-> convs.{i}.update.layers.{j}....
    {params,buffers}/GCNConv_{i}/KANLinear_0/... <-> convs.{i}.transform....
    params/GCNConv_{i}/FastKANLayer_0/...        <-> convs.{i}.transform....
    params/GCNConv_{i}/bias                      <-> convs.{i}.bias
    {params,buffers}/GATConv_{i}/KANLinear_0/... <-> convs.{i}.transform....
    params/GATConv_{i}/FastKANLayer_0/...        <-> convs.{i}.transform....
    params/GATConv_{i}/{att_src,att_dst,bias}    <-> convs.{i}.{att_src,att_dst,bias}
    params/MaskedBatchNorm_{i}/{scale,bias}      <-> norms.{i}.{weight,bias}
    batch_stats/MaskedBatchNorm_{i}/{mean,var}   <-> norms.{i}.{running_mean,running_var}
    {params,buffers}/head/...                    <-> head....
Leaves of a KANLinear keep their names (base_weight, spline_weight,
spline_scaler, the buffer grid); those of a FastKANLayer map as
    spline_weight <-> spline_linear.weight, base_weight <-> base_linear.weight,
    base_bias <-> base_linear.bias, layernorm/{scale,bias} <-> layernorm.{weight,bias}.

The layouts are the same on both sides (the JAX layers keep the torch
layouts), so every array passes through unchanged.

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


def _np(v: Any) -> np.ndarray:
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _leaves(tree: Mapping, prefix=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _module(mod: str, rest: tuple, head_is_fast: bool):
    """JAX module name and the path below it -> (torch prefix, path below
    the layer, whether the layer is a FastKANLayer)."""
    if mod == "head":
        return "head", rest, head_is_fast
    if m := re.fullmatch(r"(Fast)?KAN_(\d+)", mod):
        layer = re.fullmatch(r"layers_(\d+)", rest[0]).group(1)
        return (f"convs.{m.group(2)}.update.layers.{layer}", rest[1:],
                m.group(1) is not None)
    if m := re.fullmatch(r"G(?:CN|AT)Conv_(\d+)", mod):
        if rest in (("bias",), ("att_src",), ("att_dst",)):
            return f"convs.{m.group(1)}", rest, False
        t = re.fullmatch(r"(FastKANLayer|KANLinear)_0", rest[0])
        if t is not None:
            return (f"convs.{m.group(1)}.transform", rest[1:],
                    t.group(1) == "FastKANLayer")
    return None


def _is_fastkan_layer(tree: Mapping) -> bool:
    """A FastKANLayer's spline weight is (O, D*G); a KANLinear's is 3-D."""
    return "spline_weight" in tree and np.ndim(tree["spline_weight"]) == 2


def from_jax_variables(variables: Mapping) -> dict[str, torch.Tensor]:
    """JAX NodeClassifier variables -> the port's state_dict."""
    head_is_fast = _is_fastkan_layer(variables.get("params", {}).get("head", {}))
    sd = {}
    for path, v in _leaves(variables):
        coll, mod, rest = path[0], path[1], path[2:]
        if m := re.fullmatch(r"MaskedBatchNorm_(\d+)", mod):
            key = f"norms.{m.group(1)}.{_BN[(coll, rest[0])]}"
        elif (found := _module(mod, rest, head_is_fast)) is not None:
            prefix, leaf, fast = found
            key = f"{prefix}.{_FAST[leaf] if fast else '.'.join(leaf)}"
        else:
            raise KeyError(f"no port counterpart for {'/'.join(path)}")
        sd[key] = torch.from_numpy(np.array(_np(v), dtype=np.float32))
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
        d[path[-1]] = _np(value)

    def leaf(rest: str):
        """Torch name below a layer -> (collection, fastkan?, JAX path)."""
        if rest in _FAST_INV:
            return "params", True, _FAST_INV[rest]
        return ("buffers" if rest == "grid" else "params"), False, (rest,)

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
            coll, fast, path = leaf(".".join(parts[5:]))
            mod = f"{'FastKAN' if fast else 'KAN'}_{parts[1]}"
            put((coll, mod, f"layers_{parts[4]}", *path), v)
            continue
        if parts[0] == "convs" and parts[2] == "transform":
            coll, fast, path = leaf(".".join(parts[3:]))
            layer = "FastKANLayer_0" if fast else "KANLinear_0"
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
