"""Grid adaptation for trained or training KAN models, the counterpart of
`kagnn_tpu/kan/adapt.py` (`update_kan_linear`, `update_kan_stack`,
`adapt_model_grids`) and of the reference's in-place grid updates
(`KAN.forward(update_grid=True)`, ekan.py:270-275, and
`KANLinear.update_grid`, ekan.py:164-211).

Each KANLinear's knots are refit to the empirical distribution of its
input and its spline weight refit to the function its scaled splines
represented, layer by layer, later layers against the activations of the
layers already adapted. The port's modules hold their weights, so the
updates are made in place (`grid` and `spline_weight`), where the JAX
functions return new variable trees; the optimizer's state is left as it
is, as the JAX protocol leaves its opt_state.
"""
from __future__ import annotations

import contextlib

import torch

from kagnn_tpu_torch.kan import bspline
from kagnn_tpu_torch.kan.layers import KAN, KANLinear
from kagnn_tpu_torch.utils.port import jax_paths


@torch.no_grad()
def update_kan_linear(layer: KANLinear, x: torch.Tensor,
                      grid_eps: float = 0.02, margin: float = 0.01) -> None:
    """Adapt one KANLinear's (grid, spline_weight) to inputs `x` (rows, in),
    in place; x is read in f32, as the JAX adaptation casts it."""
    new_grid, new_w = bspline.update_grid(
        x.float(), layer.grid, layer.spline_weight, layer.spline_scaler,
        grid_size=layer.grid_size, spline_order=layer.spline_order,
        grid_eps=grid_eps, margin=margin)
    layer.grid.copy_(new_grid)
    layer.spline_weight.copy_(new_w)


@torch.no_grad()
def update_kan_stack(stack: KAN, x: torch.Tensor) -> None:
    """Adapt every layer of a `KAN` stack in turn, each against the output
    of the layers before it (evaluated in f32 by the plain forward, as the
    JAX function evaluates a fresh unfused KANLinear)."""
    x = x.float()
    for layer in stack.layers:
        update_kan_linear(layer, x)
        with _set_attrs([layer], fused=False, compute_dtype=None):
            x = layer(x)


@contextlib.contextmanager
def _set_attrs(modules, **values):
    """Set attributes on each module that has them; restore on exit."""
    saved = [(m, {k: getattr(m, k) for k in values if hasattr(m, k)})
             for m in modules]
    for m, old in saved:
        for k in old:
            setattr(m, k, values[k])
    try:
        yield
    finally:
        for m, old in saved:
            for k, v in old.items():
                setattr(m, k, v)


def kan_layers_in_jax_order(model) -> list[tuple[tuple, str, KANLinear]]:
    """(JAX module path, port module name, layer) of every KANLinear of a
    model that `utils/port.py` carries (node and graph models), in the
    order the JAX adaptation takes them: the paths of flax's intermediates
    tree, keys sorted as strings at every level (`_kan_in_paths`), which
    is not the order of execution ("KAN_10" before "KAN_2", "KAN_2" before
    "head")."""
    paths = jax_paths(model.state_dict())
    found = []
    for name, mod in model.named_modules():
        if isinstance(mod, KANLinear):
            found.append((paths[f"{name}.grid"][1:-1], name, mod))
    return sorted(found, key=lambda t: t[0])


@torch.no_grad()
def adapt_model_grids(model, *args, **kwargs) -> list[str]:
    """In-training grid adaptation of a whole model, the counterpart of the
    JAX `adapt_model_grids`: ONE KANLinear per pass, in the JAX order
    (`kan_layers_in_jax_order`), the model re-run before each pass so that
    a layer is refit against the activations of the layers adapted before
    it. Each pass runs `model(*args, **kwargs)` in eval mode with every
    module's `fused` flag off (the JAX function applies an unfused clone
    with train=False) and takes the layer's input from a forward pre-hook
    (`KANLinear.kan_input`, the tensor the JAX layer sows; the pad rows
    included). Updates the model in place; returns the adapted layers'
    module names in order."""
    layers = kan_layers_in_jax_order(model)
    was_training = model.training
    model.eval()
    try:
        with _set_attrs(list(model.modules()), fused=False):
            for _, _, layer in layers:
                seen = []

                def hook(mod, a, kw):
                    if not seen:
                        seen.append(mod.kan_input(*a, **kw))

                handle = layer.register_forward_pre_hook(hook, with_kwargs=True)
                try:
                    model(*args, **kwargs)
                finally:
                    handle.remove()
                update_kan_linear(layer, seen[0])
    finally:
        model.train(was_training)
    return [name for _, name, _ in layers]
