"""Weight carrier between the JAX `NodeClassifier` variable tree and the
port's `NodeClassifier` state_dict (gin/kan path). Works on numpy arrays:
the JAX tree's leaves come in as numpy (`jax.tree.map(np.asarray, v)`),
and nothing here imports jax.

    params/KAN_{i}/layers_{j}/{base_weight,spline_weight,spline_scaler}
        <-> convs.{i}.update.layers.{j}.{same names}
    buffers/KAN_{i}/layers_{j}/grid   <-> convs.{i}.update.layers.{j}.grid
    params/MaskedBatchNorm_{i}/{scale,bias}  <-> norms.{i}.{weight,bias}
    batch_stats/MaskedBatchNorm_{i}/{mean,var}
        <-> norms.{i}.{running_mean,running_var}
    params/head/..., buffers/head/grid <-> head.{same names}

The layouts are the same on both sides (the JAX layers keep the torch
layouts), so every array passes through unchanged.
"""
from __future__ import annotations

import re
from typing import Any, Mapping

import numpy as np
import torch

_BN = {("params", "scale"): "weight", ("params", "bias"): "bias",
       ("batch_stats", "mean"): "running_mean",
       ("batch_stats", "var"): "running_var"}


def _np(v: Any) -> np.ndarray:
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _leaves(tree: Mapping, prefix=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def from_jax_variables(variables: Mapping) -> dict[str, torch.Tensor]:
    """JAX NodeClassifier variables -> the port's state_dict."""
    sd = {}
    for path, v in _leaves(variables):
        coll, mod, name = path[0], path[1], path[-1]
        if mod == "head":
            key = f"head.{name}"
        elif m := re.fullmatch(r"KAN_(\d+)", mod):
            layer = re.fullmatch(r"layers_(\d+)", path[2]).group(1)
            key = f"convs.{m.group(1)}.update.layers.{layer}.{name}"
        elif m := re.fullmatch(r"MaskedBatchNorm_(\d+)", mod):
            key = f"norms.{m.group(1)}.{_BN[(coll, name)]}"
        else:
            raise KeyError(f"no port counterpart for {'/'.join(path)}")
        sd[key] = torch.from_numpy(np.array(_np(v), dtype=np.float32))
    return sd


def to_jax_variables(state_dict: Mapping[str, Any]) -> dict:
    """The port's state_dict -> JAX NodeClassifier variables (numpy)."""
    inv_bn = {v: k for k, v in _BN.items()}
    out: dict = {}

    def put(path, value):
        d = out
        for p in path[:-1]:
            d = d.setdefault(p, {})
        d[path[-1]] = _np(value)

    for key, v in state_dict.items():
        parts = key.split(".")
        if parts[0] == "head":
            coll = "buffers" if parts[1] == "grid" else "params"
            put((coll, "head", parts[1]), v)
        elif parts[0] == "convs":
            coll = "buffers" if parts[-1] == "grid" else "params"
            put((coll, f"KAN_{parts[1]}", f"layers_{parts[4]}", parts[-1]), v)
        elif parts[0] == "norms":
            coll, name = inv_bn[parts[2]]
            put((coll, f"MaskedBatchNorm_{parts[1]}", name), v)
        else:
            raise KeyError(f"no JAX counterpart for {key}")
    return out
