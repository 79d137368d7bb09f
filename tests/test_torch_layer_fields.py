"""The layers' remaining fields against the JAX layers on the CPU: the
KANLinear fields (`scale_noise`, `scale_base`, `scale_spline`,
`enable_standalone_scale_spline`, `base_activation`, `grid_eps`,
`grid_range`, `param_dtype`), the KAN stack's, the FastKANLayer fields
(`grid_min`, `grid_max`, `base_activation`, `spline_weight_init_scale`,
`param_dtype`), the FastKAN stack's, `FastKANLayer.plot_curve`, and a grid
adaptation of a stack with a non-default grid range.

Every layer runs fused and unfused: on the CPU the port's fused layers run
their kernels' plain versions, the JAX fused layers their Pallas kernels in
interpret mode. The weights are the JAX layer's, carried into the port.
`base_activation` is tanh on both sides (`jnp.tanh` / `torch.tanh`): the
unfused paths and the RBF product's route call it, while the fused
B-spline call, the whole-layer FastKAN kernel and the GIN fusion points
run SiLU whatever the field says, as the JAX layers do.

Tolerances: f32 values rtol 1e-4 / atol 1e-5, gradients rtol 1e-3 / atol
1e-5 (the same arithmetic in another summation order), here of the output's
scale where a fused JAX kernel's one-hot products carry the values. With
bf16 parameters and an f32 input (param_dtype bfloat16, no compute dtype)
the outputs and the input's gradient are f32 products of the exact bf16
weights, held to the f32 bars; each parameter gradient is bf16, held to 4
bf16 ulps of its scale (fused: the JAX kernel's walk over its row tiles, in
bf16, which the port's plain versions repeat)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kagnn_tpu.kan import adapt as jadapt
from kagnn_tpu.kan.layers import KAN as JKAN
from kagnn_tpu.kan.layers import FastKAN as JFastKAN
from kagnn_tpu.kan.layers import FastKANLayer as JFastKANLayer
from kagnn_tpu.kan.layers import KANLinear as JKANLinear
from kagnn_tpu_torch.kan import FastKAN, FastKANLayer, KANLinear
from kagnn_tpu_torch.kan import adapt as tadapt
from kagnn_tpu_torch.kan.layers import KAN
from kagnn_tpu_torch.utils.port import fastkan_from_jax

torch.set_num_threads(1)

VAL = dict(rtol=1e-4, atol=1e-5)
GRAD = dict(rtol=1e-3, atol=1e-5)
BF16_ULP = 2.0 ** -8
N, D, O = 300, 6, 5  # 3 row tiles of the fused B-spline backward


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def close(got, want, bar, what=""):
    """|got - want| <= rtol * the output's scale + atol (f32 bars), or 4
    bf16 ulps of the scale (bar "bf16")."""
    got, want = _f32(got), _f32(want)
    scale = max(float(np.abs(want).max()), 1e-6)
    tol = 4 * BF16_ULP * scale if bar == "bf16" else bar["rtol"] * scale + bar["atol"]
    err = float(np.abs(got - want).max())
    assert err <= tol, f"{what}: max err {err} > {tol}"


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(N, D)) * 0.8).astype(np.float32)
    cot = rng.normal(size=(N, O)).astype(np.float32)
    return x, cot


def _jax_run(mod, variables, x, cot):
    """The JAX module's output and the gradients of sum(out * cot) with
    respect to its params and x."""
    def f(params, x):
        out = mod.apply({**variables, "params": params}, x)
        return (out.astype(jnp.float32) * cot).sum(), out

    (_, out), (gp, gx) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
        variables["params"], jnp.asarray(x))
    return out, gp, gx


def _port_run(layer, x, cot):
    xt = torch.from_numpy(x).requires_grad_(True)
    out = layer(xt)
    (out.float() * torch.from_numpy(cot)).sum().backward()
    return out, {n: p.grad for n, p in layer.named_parameters()}, xt.grad


def _kan_pair(fused, **fields):
    """(JAX KANLinear, its variables, the port's KANLinear with them)."""
    jfields = dict(fields)
    act = jfields.pop("base_activation", None)
    pdt = jfields.pop("param_dtype", None)
    jkw = dict(jfields, fused=fused)
    tkw = dict(jfields, fused=fused, device="cpu")
    if act is not None:
        jkw["base_activation"], tkw["base_activation"] = jnp.tanh, torch.tanh
    if pdt is not None:
        jkw["param_dtype"], tkw["param_dtype"] = jnp.bfloat16, torch.bfloat16
    jm = JKANLinear(D, O, grid_size=4, spline_order=3, **jkw)
    variables = jm.init(jax.random.key(1), jnp.zeros((N, D), jnp.float32))
    tm = KANLinear(D, O, grid_size=4, spline_order=3, **tkw)
    sd = {k: torch.from_numpy(np.array(_f32(v))) for coll in ("params", "buffers")
          for k, v in variables[coll].items()}
    tm.load_state_dict(sd)
    return jm, variables, tm


KAN_FIELDS = {
    "tanh": dict(base_activation="tanh"),
    "range": dict(grid_range=(-2.0, 3.0), grid_eps=0.1),
    "no_scaler": dict(enable_standalone_scale_spline=False, scale_spline=2.0),
    "scales": dict(scale_noise=0.3, scale_base=0.5, scale_spline=1.5),
    "bf16_params": dict(param_dtype="bf16"),
}


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
@pytest.mark.parametrize("case", sorted(KAN_FIELDS))
def test_kanlinear_fields_match_jax(case, fused):
    """Value, input gradient and every parameter gradient of a KANLinear
    with one field set off its default, fused and unfused, against the JAX
    layer."""
    fields = KAN_FIELDS[case]
    jm, variables, tm = _kan_pair(fused, **fields)
    x, cot = _inputs()
    jout, jgp, jgx = _jax_run(jm, variables, x, cot)
    out, tgp, tgx = _port_run(tm, x, cot)
    assert out.dtype == torch.float32
    close(out, jout, VAL, "out")
    close(tgx, jgx, GRAD, "dx")
    bf16 = case == "bf16_params"
    assert set(tgp) == set(jgp)
    for k, g in tgp.items():
        assert g.dtype == (torch.bfloat16 if bf16 else torch.float32), k
        close(g, jgp[k], "bf16" if bf16 else GRAD, k)
    if case == "no_scaler":
        assert "spline_scaler" not in tm.state_dict()
        assert torch.equal(tm.scaled_spline_weight, tm.spline_weight)
        np.testing.assert_allclose(tm.regularization_loss().item(),
                                   float(jm.apply(variables, method=JKANLinear.regularization_loss)),
                                   **VAL)
    if case == "range":
        np.testing.assert_allclose(tm.grid.numpy(), _f32(variables["buffers"]["grid"]), **VAL)


def test_kanlinear_fused_runs_silu_whatever_the_activation():
    """The JAX quirk the port keeps: the fused call takes no activation,
    so a fused tanh layer computes the SiLU layer, an unfused one tanh."""
    x, _ = _inputs()
    _, _, fused_tanh = _kan_pair(True, base_activation="tanh")
    _, _, silu = _kan_pair(False)
    _, _, tanh = _kan_pair(False, base_activation="tanh")
    xt = torch.from_numpy(x)
    close(fused_tanh(xt), silu(xt), VAL, "fused tanh = silu")
    assert not torch.allclose(fused_tanh(xt), tanh(xt), **VAL)


def test_kanlinear_init_follows_the_scales():
    """The fields that only shape the init: scale_base widens the base
    weight's kaiming bound, scale_spline multiplies the spline weight when
    there is no standalone scaler (and the scaler's bound when there is),
    and scale_noise the fitted noise; the grid spans grid_range."""
    def layer(**kw):
        return KANLinear(D, O, grid_size=4, spline_order=3, device="cpu",
                         generator=torch.Generator().manual_seed(3), **kw)

    base = layer()
    assert torch.allclose(layer(enable_standalone_scale_spline=False,
                                scale_spline=2.0).spline_weight,
                          2.0 * layer(enable_standalone_scale_spline=False).spline_weight)
    assert torch.allclose(layer(scale_noise=0.3).spline_weight, 3.0 * base.spline_weight,
                          rtol=1e-4, atol=1e-6)
    a = np.sqrt(5) * 0.5
    bound = np.sqrt(2.0 / (1 + a * a)) * np.sqrt(3.0 / D)
    w = layer(scale_base=0.5).base_weight
    assert float(w.abs().max()) <= bound and float(w.abs().max()) > 0.8 * bound
    grid = layer(grid_range=(-2.0, 3.0)).grid
    assert float(grid[0, 3]) == -2.0 and float(grid[0, -4]) == 3.0
    assert layer(param_dtype=torch.bfloat16).base_weight.dtype == torch.bfloat16


def _fast_pair(fused, use_layernorm=True, use_base_update=True, **fields):
    jkw, tkw = dict(fields), dict(fields)
    if "base_activation" in fields:
        jkw["base_activation"], tkw["base_activation"] = jnp.tanh, torch.tanh
    if "param_dtype" in fields:
        jkw["param_dtype"], tkw["param_dtype"] = jnp.bfloat16, torch.bfloat16
    common = dict(num_grids=4, use_layernorm=use_layernorm,
                  use_base_update=use_base_update, fused=fused)
    jm = JFastKANLayer(D, O, **common, **jkw)
    variables = jm.init(jax.random.key(2), jnp.zeros((N, D), jnp.float32))
    tm = FastKANLayer(D, O, **common, device="cpu", **tkw)
    tm.load_state_dict(fastkan_from_jax(variables))
    return jm, variables, tm


FAST_FIELDS = {
    "tanh": dict(base_activation="tanh"),
    "range": dict(grid_min=-1.0, grid_max=3.0),
    "bf16_params": dict(param_dtype="bf16"),
}


@pytest.mark.parametrize("route", ["unfused", "whole", "rbf"])
@pytest.mark.parametrize("case", sorted(FAST_FIELDS))
def test_fastkan_layer_fields_match_jax(case, route):
    """A FastKANLayer with one field off its default on each route: the
    unfused layer, the whole-layer kernel (fused, layernorm and base update
    on: SiLU whatever the activation) and the RBF product's route (fused,
    no layernorm: the activation called), against the JAX layer."""
    fields = FAST_FIELDS[case]
    jm, variables, tm = _fast_pair(route != "unfused", use_layernorm=route != "rbf",
                                   **fields)
    x, cot = _inputs(1)
    jout, jgp, jgx = _jax_run(jm, variables, x, cot)
    out, tgp, tgx = _port_run(tm, x, cot)
    close(out, jout, VAL, "out")
    close(tgx, jgx, GRAD, "dx")
    bf16 = case == "bf16_params"
    names = {"spline_linear.weight": ("spline_weight",),
             "base_linear.weight": ("base_weight",), "base_linear.bias": ("base_bias",),
             "layernorm.weight": ("layernorm", "scale"), "layernorm.bias": ("layernorm", "bias")}
    for k, g in tgp.items():
        want = jgp
        for p in names[k]:
            want = want[p]
        assert g.dtype == (torch.bfloat16 if bf16 else torch.float32), k
        close(g, want, "bf16" if bf16 else GRAD, k)


def test_fastkan_stacks_pass_their_fields_down(rng):
    """FastKAN's grid range, activation and init scale reach its layers, and
    the stack computes the JAX stack (unfused, tanh)."""
    x = (rng.normal(size=(40, D)) * 0.8).astype(np.float32)
    kw = dict(grid_min=-1.5, grid_max=2.5, num_grids=5)
    jm = JFastKAN([D, 7, O], base_activation=jnp.tanh, spline_weight_init_scale=0.3, **kw)
    variables = jm.init(jax.random.key(3), jnp.asarray(x))
    tm = FastKAN([D, 7, O], base_activation=torch.tanh, spline_weight_init_scale=0.3,
                 device="cpu", **kw)
    tm.load_state_dict(fastkan_from_jax(variables))
    assert all(l.grid_min == -1.5 and l.grid_max == 2.5 and l.base_activation is torch.tanh
               and l.spline_weight_init_scale == 0.3 for l in tm.layers)
    close(tm(torch.from_numpy(x)), jm.apply(variables, jnp.asarray(x)), VAL, "stack")
    w = FastKAN([D, O], spline_weight_init_scale=0.3, device="cpu").layers[0]
    assert 0.3 < float(w.spline_linear.weight.abs().max()) <= 0.6


def test_kan_stack_fields_and_adaptation_match_jax(rng):
    """A KAN stack with a non-default grid range, grid_eps and activation:
    its forward, then `update_kan_stack` (the stack's grid_eps; the
    evaluation between layers with SiLU, as the fresh JAX layer has),
    against the JAX stack and its adaptation."""
    x = (rng.normal(size=(64, D)) * 1.5).astype(np.float32)
    kw = dict(grid_size=4, spline_order=3, grid_range=(-2.0, 2.0), grid_eps=0.1)
    jm = JKAN([D, 7, O], base_activation=jnp.tanh, **kw)
    variables = jm.init(jax.random.key(4), jnp.asarray(x))
    tm = KAN([D, 7, O], base_activation=torch.tanh, device="cpu", **kw)
    sd = {f"layers.{k.split('_')[1]}.{n}": torch.from_numpy(_f32(v))
          for coll in ("params", "buffers") for k, leaves in variables[coll].items()
          for n, v in leaves.items()}
    tm.load_state_dict(sd)
    close(tm(torch.from_numpy(x)), jm.apply(variables, jnp.asarray(x)), VAL, "stack")
    want = jadapt.update_kan_stack(jm, variables, jnp.asarray(x))
    tadapt.update_kan_stack(tm, torch.from_numpy(x))
    for i in range(2):
        layer = tm.layers[i]
        np.testing.assert_allclose(layer.grid.numpy(),
                                   _f32(want["buffers"][f"layers_{i}"]["grid"]), **VAL)
        close(layer.spline_weight, want["params"][f"layers_{i}"]["spline_weight"], GRAD,
              f"layer {i} spline_weight")


def test_plot_curve_matches_jax():
    """FastKANLayer.plot_curve: the curve of one (input, output) pair on
    the widened grid, against the JAX method, at a non-default range."""
    jm, variables, tm = _fast_pair(False, grid_min=-1.0, grid_max=3.0)
    for i, o, pts, ext in ((0, 0, 1000, 2), (D - 1, O - 1, 57, 1)):
        jx, jy = jm.apply(variables, i, o, pts, ext, method=JFastKANLayer.plot_curve)
        x, y = tm.plot_curve(i, o, num_pts=pts, num_extrapolate_bins=ext)
        assert x.shape == (pts,) and y.shape == (pts,)
        close(x, jx, VAL, "x")
        close(y, jy, VAL, "y")
