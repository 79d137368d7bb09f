"""Port reference (torch) KAN weights into the port's checkpoints, the
counterpart of `experiments/port_checkpoint.py` (which writes the JAX
package's Orbax checkpoints).

Reads a state_dict saved with torch.save (the reference saves these at
node_classification_clean/utils.py:163; a whole pickled module gives its
state_dict) in the reference layouts, which the port's modules keep: an
efficient-kan KANLinear (`base_weight`, `spline_weight`, `spline_scaler`
when it has a standalone scaler, the `grid` buffer) or KAN stack
(`layers.{i}.`...), a fastkan FastKANLayer (`spline_linear.weight`,
`layernorm.{weight,bias}`, `base_linear.{weight,bias}`, the centers
`rbf.grid`) or FastKAN stack. The port's module is built from the
tensors' shapes (the spline order and grid size from the knot buffer's and
spline weight's widths; the centers, their range and the layer's flags
from the keys present), loads them, and is written with
`train/checkpoint.py::save` (restore it into the same module with
`checkpoint.restore`).

    python -m kagnn_tpu_torch.experiments.port_checkpoint \\
        --torch_file model.pt --family kan --layers 2 --out ckpt.pt

The module is built on the card unless `KAGNN_PLATFORM=cpu`.
"""
from __future__ import annotations

import argparse


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--torch_file", required=True)
    p.add_argument("--family", required=True,
                   choices=["kan", "fastkan", "kan_linear", "fastkan_layer"])
    p.add_argument("--layers", type=int, default=1,
                   help="stacked layers (the kan and fastkan families)")
    p.add_argument("--prefix", default="", help="the state_dict's key prefix")
    p.add_argument("--out", required=True, help="the checkpoint file to write")
    return p.parse_args(argv)


def kan_linear(sd, prefix: str, device):
    """A port KANLinear holding the reference KANLinear at `prefix`."""
    from kagnn_tpu_torch.kan import KANLinear

    O, D, C = sd[prefix + "spline_weight"].shape
    order = sd[prefix + "grid"].shape[1] - C - 1
    scaler = prefix + "spline_scaler" in sd
    layer = KANLinear(D, O, grid_size=C - order, spline_order=order,
                      enable_standalone_scale_spline=scaler, device=device)
    keys = ["base_weight", "spline_weight", "grid"] + (["spline_scaler"] if scaler else [])
    layer.load_state_dict({k: sd[prefix + k] for k in keys})
    return layer


def fastkan_layer(sd, prefix: str, device):
    """A port FastKANLayer holding the reference FastKANLayer at `prefix`:
    its flags from the keys present, its centers from `rbf.grid` (or, when
    the file has none, the reference's default range with as many centers
    as the spline weight's columns a feature)."""
    from kagnn_tpu_torch.kan import FastKANLayer

    ln = prefix + "layernorm.weight" in sd
    base = prefix + "base_linear.weight" in sd
    O, cols = sd[prefix + "spline_linear.weight"].shape
    if ln:
        D = sd[prefix + "layernorm.weight"].shape[0]
    elif base:
        D = sd[prefix + "base_linear.weight"].shape[1]
    else:
        raise ValueError(f"{prefix or 'the layer'}: without a layernorm or a base "
                         f"update the input width is not in the state_dict")
    grid = sd.get(prefix + "rbf.grid")
    G = cols // D if grid is None else grid.numel()
    lo, hi = (-2.0, 2.0) if grid is None else (float(grid[0]), float(grid[-1]))
    layer = FastKANLayer(D, O, grid_min=lo, grid_max=hi, num_grids=G,
                         use_layernorm=ln, use_base_update=base, device=device)
    keys = (["spline_linear.weight"] + (["layernorm.weight", "layernorm.bias"] if ln else [])
            + (["base_linear.weight", "base_linear.bias"] if base else []))
    layer.load_state_dict({k: sd[prefix + k] for k in keys})
    return layer


def load_state_dict(path: str) -> dict:
    """A state_dict saved with torch.save, or the state_dict of a whole
    module pickled with it (whose classes must then be importable)."""
    import pickle

    import torch

    try:
        obj = torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError:  # a pickled module, not a plain dict
        obj = torch.load(path, map_location="cpu", weights_only=False)
    return obj if isinstance(obj, dict) else obj.state_dict()


def main(argv=None):
    from torch import nn

    from kagnn_tpu_torch.train import checkpoint
    from kagnn_tpu_torch.utils.platform import platform_device

    args = parse_args(argv)
    device = platform_device()
    sd = load_state_dict(args.torch_file)
    one = kan_linear if args.family.startswith("kan") else fastkan_layer
    if args.family in ("kan_linear", "fastkan_layer"):
        module = one(sd, args.prefix, device)
    else:
        stack = nn.Module()
        stack.layers = nn.ModuleList(one(sd, f"{args.prefix}layers.{i}.", device)
                                     for i in range(args.layers))
        module = stack
    checkpoint.save(args.out, module)
    n = sum(p.numel() for p in module.parameters())
    print(f"ported {args.family} ({n} parameters) -> {args.out}")
    return module


if __name__ == "__main__":
    main()
