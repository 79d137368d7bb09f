"""The port's RBF spline product (kernels/rbf_fused.py) and the FastKANLayer /
FastKAN options that route to it, against the JAX package on the same numpy
inputs:

  * `rbf_spline_matmul` against `pallas/rbf_fused.py` in interpret mode:
    value, dx and dW for (x, w) in f32/f32, f32/bf16 and bf16/bf16, G 4 and
    8, and a dW summed over 13 row tiles of 512;
  * `FastKANLayer` for every combination of layernorm, base update and
    fused, in f32 and bf16, and the call-time `use_layernorm=False`, against
    the JAX layer (its fused path runs its Pallas kernels in interpret mode
    on the CPU by itself), with the weights carried by
    `utils/port.py::fastkan_from_jax`;
  * the base-free FastKAN's 3-step Adam trajectory in bf16, the slice's
    step.

On the CPU every wrapper runs its plain PyTorch version, so these tests hold
the plain versions (the arithmetic each CUDA kernel must reproduce) against
the TPU kernels; tests/test_torch_cuda.py and chip_smoke.py hold the CUDA
kernels against the plain versions on the card.

Tolerances: f32 values rtol 1e-4 / atol 1e-5, gradients rtol 1e-3 /
atol 1e-5 (the same f32 arithmetic in another summation order). bf16:
max |port - jax| <= 4 bf16 ulps (4 * 2^-8) of the output's scale, for an
output in bf16 or computed from bf16 operands: both round at the same
points, but XLA keeps f32 between some fused elementwise ops (see
`test_bf16_basis_rounds_where_the_jax_kernel_does`)."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from kagnn_tpu.kan.layers import FastKAN as JFastKAN
from kagnn_tpu.kan.layers import FastKANLayer as JFastKANLayer
from kagnn_tpu.pallas import rbf_fused as jrbf
from kagnn_tpu.train import losses as jlosses
from kagnn_tpu_torch.kan import FastKAN, FastKANLayer
from kagnn_tpu_torch.kernels import rbf_fused as rf
from kagnn_tpu_torch.kernels import spmm
from kagnn_tpu_torch.train import masked_softmax_cross_entropy
from kagnn_tpu_torch.utils import port

torch.set_num_threads(1)

VAL = dict(rtol=1e-4, atol=1e-5)
GRAD = dict(rtol=1e-3, atol=1e-5)
BF16_ULP = 2.0 ** -8
DT = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
# (x, w) dtypes of the RBF product: no compute dtype, the layernorm-on layer
# under bf16 (LayerNorm returns f32), the layernorm-free layer under bf16
XW = [("f32", "f32"), ("f32", "bf16"), ("bf16", "bf16")]


def _np32(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def close(got, want, dt, grad=False, err_msg=""):
    """f32: elementwise rtol/atol; bf16: 4 bf16 ulps of want's scale."""
    got, want = _np32(got), _np32(want)
    if dt == "f32":
        np.testing.assert_allclose(got, want, err_msg=err_msg,
                                   **(GRAD if grad else VAL))
        return
    tol = 4 * BF16_ULP * max(float(np.abs(want).max()), 1e-6)
    err = float(np.abs(got - want).max())
    assert err <= tol, f"{err_msg}: max err {err} > {tol}"


def _jax_rbf(x, w_gdo, dout, G, grid=(-2.0, 2.0)):
    """(out, dx, dW (G*D, O)) of the JAX kernel in interpret mode."""
    den = (grid[1] - grid[0]) / (G - 1)
    out, vjp = jax.vjp(lambda a, b: jrbf.rbf_spline_matmul(
        a, b, grid[0], grid[1], G, den, True), x, w_gdo)
    dx, dw = vjp(dout)
    return out, dx, dw.reshape(-1, dw.shape[-1])


def _port_rbf(x, w, dout, grid=(-2.0, 2.0)):
    """(out, dx, dW) through the autograd Function (plain versions on the CPU)."""
    xt, wt = (t.clone().requires_grad_(True) for t in (x, w))
    out = rf.RbfSplineMatmul.apply(xt, wt, *grid)
    out.backward(dout)
    return out, xt.grad, wt.grad


def _inputs(rng, n, d, o, G, xd, wd):
    x = (rng.normal(size=(n, d)) * 1.5).astype(np.float32)
    w = (rng.normal(size=(G, d, o)) * 0.3).astype(np.float32)
    dout = rng.normal(size=(n, o)).astype(np.float32)
    jx, jw = jnp.asarray(x, DT[xd][0]), jnp.asarray(w, DT[wd][0])
    jd = jnp.asarray(dout, DT[xd][0])
    tx, tw, td = (torch.tensor(_np32(a)).to(DT[k][1])
                  for a, k in ((jx, xd), (jw.reshape(G * d, o), wd), (jd, xd)))
    return (jx, jw, jd), (tx, tw, td)


@pytest.mark.parametrize("G", [4, 8])
@pytest.mark.parametrize("xw", XW, ids=["-".join(p) for p in XW])
def test_rbf_spline_matmul_matches_jax(rng, xw, G):
    """Value, dx and dW, each in its dtype: out and dx in x's, dW in w's."""
    xd, wd = xw
    (jx, jw, jd), (tx, tw, td) = _inputs(rng, 300, 6, 5, G, xd, wd)
    want = _jax_rbf(jx, jw, jd, G)
    got = _port_rbf(tx, tw, td)
    assert [a.dtype for a in got] == [DT[xd][1], DT[xd][1], DT[wd][1]]
    assert [a.dtype for a in want] == [DT[xd][0], DT[xd][0], DT[wd][0]]
    bf = "bf16" if "bf16" in xw else "f32"  # products of bf16 operands
    for name, a, b, grad in zip(("out", "dx", "dw"), got, want,
                                (False, True, True)):
        close(a, b, bf, grad=grad, err_msg=name)


@pytest.mark.parametrize("xw", XW[1:], ids=["-".join(p) for p in XW[1:]])
def test_rbf_dw_ordered_bf16_sum_over_many_tiles_matches_jax(rng, xw):
    """6,200 rows are 13 tiles of 512: the JAX kernel adds the tiles' dW
    partials in bf16, rounding after each. The port does the same and meets
    it within 1 bf16 ulp of dW's scale; the same partials summed in f32
    and rounded once land further away (about 1.4 % of the scale for a bf16
    x: over 3 ulps)."""
    xd, wd = xw
    G = 8
    (jx, jw, jd), (tx, tw, td) = _inputs(rng, 6200, 8, 8, G, xd, wd)
    _, _, dw_j = _jax_rbf(jx, jw, jd, G)
    _, dw_t = rf.rbf_spline_bwd(tx, tw, td, -2.0, 2.0, need_dx=False)
    want = _np32(dw_j)
    ulp = BF16_ULP * np.abs(want).max()
    err = np.abs(_np32(dw_t) - want).max()
    c, ih = rf.constants(-2.0, 2.0, G, tx.dtype)
    b, _ = rf.basis_plain(tx, c, ih, round_exp=False)
    f32_sum = (b.T @ td.float()).to(torch.bfloat16)
    err_f32 = np.abs(_np32(f32_sum) - want).max()
    assert err <= ulp < err_f32, (err / ulp, err_f32 / ulp)


def test_bf16_basis_rounds_where_the_jax_kernel_does(rng):
    """x in bf16: the JAX kernel computes the distance in bf16 (centers,
    x - c, times inv_h, squared), but XLA keeps exp in f32 where the
    backward multiplies it in f32, and rounds it to bf16 before the
    forward's bf16 product. The port's forward (rounded basis) meets the
    JAX output bit for bit on more elements than an unrounded basis does;
    its backward (f32 exp) meets the JAX dW bit for bit, a rounded basis
    does not."""
    G, n, d, o = 8, 2000, 8, 8
    (jx, jw, jd), (tx, tw, td) = _inputs(rng, n, d, o, G, "bf16", "bf16")
    out_j, _, dw_j = (_np32(a) for a in _jax_rbf(jx, jw, jd, G))
    c, ih = rf.constants(-2.0, 2.0, G, torch.bfloat16)

    def fwd(round_exp):
        b, _ = rf.basis_plain(tx, c, ih, round_exp)
        return _np32((b @ tw.float()).to(torch.bfloat16))

    def dw(round_exp):
        b, _ = rf.basis_plain(tx, c, ih, round_exp)
        acc = torch.zeros(G * d, o)
        for r0 in range(0, n, 512):
            part = (b[r0:r0 + 512].T @ td[r0:r0 + 512].float()).bfloat16().float()
            acc = (acc + part).bfloat16().float()
        return _np32(acc)

    assert np.array_equal(fwd(True), _np32(rf.rbf_spline_fwd(tx, tw, -2.0, 2.0)))
    assert np.array_equal(dw(False), _np32(rf.rbf_spline_bwd(tx, tw, td, -2.0, 2.0)[1]))
    assert (fwd(True) == out_j).mean() > (fwd(False) == out_j).mean()
    assert np.array_equal(dw(False), dw_j)
    assert not np.array_equal(dw(True), dw_j)


def test_constants_are_the_jax_kernels(rng):
    """f32: c_0 + g * step in f32 (`fastkan_layer.centers`); bf16: each
    operation of the JAX `_wide_basis` center row rounded to bf16."""
    for G in (4, 8):
        c, ih = rf.constants(-2.0, 2.0, G, torch.float32)
        lin = np.linspace(-2.0, 2.0, G).astype(np.float32)
        np.testing.assert_array_equal(c.numpy(), lin[0] + np.arange(
            G, dtype=np.float32) * np.float32(lin[1] - lin[0]))
        cb, ihb = rf.constants(-2.0, 2.0, G, torch.bfloat16)
        bf = jnp.bfloat16
        want = (jnp.asarray(float(lin[0]), bf)
                + jnp.arange(G).astype(bf) * jnp.asarray(float(lin[1] - lin[0]), bf))
        np.testing.assert_array_equal(cb.numpy(), _np32(want))
        assert ih == ihb == (G - 1) / 4.0


def _jax_layer(x, kw, call_ln=True, key=0):
    """JAX FastKANLayer: (variables, output, grads of sum(out * wt) for the
    params and x) for a fixed linear read-out wt."""
    jm = JFastKANLayer(**kw)
    v = jm.init(jax.random.key(key), jnp.asarray(x))
    wt = np.random.default_rng(7).normal(size=(x.shape[0], kw["output_dim"]))

    def loss(params, x_):
        o = jm.apply({"params": params}, x_, use_layernorm=call_ln)
        return jnp.sum(o.astype(jnp.float32) * wt), o

    (_, out), (gp, gx) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        v["params"], jnp.asarray(x))
    return v, out, gp, gx, wt


def _check_layer(x, kw, dt, call_ln=True):
    v, out_j, gp, gx, wt = _jax_layer(x, kw, call_ln)
    pkw = {k: val for k, val in kw.items() if k != "compute_dtype"}
    pkw.update(compute_dtype=None if dt == "f32" else torch.bfloat16,
               device="cpu")
    m = FastKANLayer(**pkw)
    m.load_state_dict(port.fastkan_from_jax(v))
    xt = torch.from_numpy(x).requires_grad_(True)
    out = m(xt, use_layernorm=call_ln)
    assert str(out.dtype) == f"torch.{out_j.dtype}"
    close(out, out_j, dt, err_msg="out")
    (out.float() * torch.from_numpy(wt).float()).sum().backward()
    close(xt.grad, gx, dt, grad=True, err_msg="dx")
    want = port.fastkan_from_jax({"params": gp})
    assert sorted(want) == sorted(n for n, _ in m.named_parameters())
    for name, p in m.named_parameters():
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        close(g, want[name], dt, grad=True, err_msg=name)


@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
@pytest.mark.parametrize("base", [True, False], ids=["base", "nobase"])
@pytest.mark.parametrize("ln", [True, False], ids=["ln", "noln"])
@pytest.mark.parametrize("dt", sorted(DT))
def test_fastkan_layer_flags_match_jax(rng, dt, ln, base, fused):
    """Value, dx and every parameter gradient. fused routes as the JAX
    layer: the whole-layer kernel with both on, else the RBF product."""
    x = rng.normal(size=(33, 6)).astype(np.float32)
    kw = dict(input_dim=6, output_dim=5, num_grids=8, use_layernorm=ln,
              use_base_update=base, fused=fused, compute_dtype=DT[dt][0]
              if dt == "bf16" else None)
    _check_layer(x, kw, dt)


@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
@pytest.mark.parametrize("dt", sorted(DT))
def test_call_time_use_layernorm_false_matches_jax(rng, dt, fused):
    """`layer(x, use_layernorm=False)` skips the layernorm of a layer that
    has one (its parameters get no gradient: zero on the JAX side)."""
    x = rng.normal(size=(33, 6)).astype(np.float32)
    kw = dict(input_dim=6, output_dim=5, num_grids=4, fused=fused,
              compute_dtype=DT[dt][0] if dt == "bf16" else None)
    _check_layer(x, kw, dt, call_ln=False)


@pytest.mark.parametrize("xw", [XW[0], XW[2]], ids=["f32-f32", "bf16-bf16"])
def test_rbf_spline_matmul_grid_range_matches_jax(rng, xw):
    """The kernels take any grid range: centers on [-1, 3], 5 of them (the
    layers keep the JAX layer's [-2, 2])."""
    xd, wd = xw
    (jx, jw, jd), (tx, tw, td) = _inputs(rng, 300, 6, 5, 5, xd, wd)
    jx = jx + 1.0  # about the range's middle
    want = _jax_rbf(jx, jw, jd, 5, grid=(-1.0, 3.0))
    got = _port_rbf(torch.tensor(_np32(jx)).to(tx.dtype), tw, td,
                    grid=(-1.0, 3.0))
    for name, a, b, grad in zip(("out", "dx", "dw"), got, want,
                                (False, True, True)):
        close(a, b, xd, grad=grad, err_msg=name)


def test_fastkan_flags_build_the_reference_modules():
    """A flag that is off creates no submodule (the reference's state_dict
    keys); layernorm on 1-D inputs raises only when the layernorm is on; the
    spline weight is a truncated normal on [-2, 2] times 0.1."""
    m = FastKANLayer(4, 3, use_layernorm=False, use_base_update=False,
                     device="cpu")
    assert list(m.state_dict()) == ["spline_linear.weight"]
    assert 0.0 < m.spline_linear.weight.abs().max() <= 0.2
    assert sorted(FastKANLayer(4, 3, use_base_update=False,
                               device="cpu").state_dict()) == [
        "layernorm.bias", "layernorm.weight", "spline_linear.weight"]
    FastKANLayer(1, 3, use_layernorm=False, device="cpu")
    with pytest.raises(ValueError, match="1D inputs"):
        FastKANLayer(1, 3, device="cpu")
    net = FastKAN([4, 3, 2], num_grids=5, use_base_update=False, device="cpu")
    assert all(not hasattr(layer, "base_linear") and layer.use_layernorm
               and layer.num_grids == 5 for layer in net.layers)


def test_fastkan_carrier_round_trips(rng):
    """Bare FastKAN / FastKANLayer trees, with the layernorm or the base
    leaves missing, to the port's state_dict and back."""
    x = jnp.asarray(rng.normal(size=(4, 6)).astype(np.float32))
    for jm, m in ((JFastKAN([6, 5, 3], use_base_update=False),
                   FastKAN([6, 5, 3], use_base_update=False, device="cpu")),
                  (JFastKANLayer(6, 3, use_layernorm=False),
                   FastKANLayer(6, 3, use_layernorm=False, device="cpu"))):
        v = jax.tree.map(np.asarray, jm.init(jax.random.key(0), x))
        m.load_state_dict(port.fastkan_from_jax(v))
        back = port.fastkan_to_jax(m.state_dict())
        assert jax.tree.structure(back) == jax.tree.structure(dict(v))
        for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(dict(v))):
            np.testing.assert_array_equal(a, b)


def test_node_carrier_detects_a_fastkan_head_without_base():
    """`from_jax_variables` tells a FastKANLayer head from a KANLinear one by
    its 2-D spline weight, so a head without base leaves maps too."""
    fast = {"params": {"head": {"spline_weight": np.ones((3, 8), np.float32),
                                "layernorm": {"scale": np.ones(2, np.float32),
                                              "bias": np.zeros(2, np.float32)}}}}
    assert sorted(port.from_jax_variables(fast)) == [
        "head.layernorm.bias", "head.layernorm.weight", "head.spline_linear.weight"]
    kan = {"params": {"head": {"base_weight": np.ones((3, 2), np.float32),
                               "spline_weight": np.ones((3, 2, 7), np.float32),
                               "spline_scaler": np.ones((3, 2), np.float32)}},
           "buffers": {"head": {"grid": np.ones((2, 11), np.float32)}}}
    assert sorted(port.from_jax_variables(kan)) == [
        "head.base_weight", "head.grid", "head.spline_scaler", "head.spline_weight"]


def test_base_free_fastkan_bf16_trajectory_matches_jax(rng):
    """The slice's step at a small size: FastKAN([16, 8, 8, 5], num_grids 8,
    use_base_update=False, fused, bf16) on 120 node rows, masked CE and
    Adam(1e-3), 3 steps. Loss trajectory and first logits within 4 bf16 ulps
    of their scale."""
    n, dims = 120, [16, 8, 8, 5]
    x = rng.normal(size=(n, 16)).astype(np.float32)
    y = rng.integers(0, 5, n)
    mask = rng.random(n) < 0.7
    jm = JFastKAN(dims, num_grids=8, use_base_update=False, fused=True,
                  compute_dtype=jnp.bfloat16)
    v = jm.init(jax.random.key(3), jnp.asarray(x))

    def loss_fn(p):
        logits = jm.apply({"params": p}, jnp.asarray(x))
        return jlosses.masked_softmax_cross_entropy(
            logits, jnp.asarray(y), jnp.asarray(mask)), logits

    grad_fn = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    tx = optax.adam(1e-3)
    params, state = v["params"], tx.init(v["params"])
    losses_j, logits_j = [], None
    for _ in range(3):
        (loss, logits), g = grad_fn(params)
        logits_j = logits if logits_j is None else logits_j
        losses_j.append(float(loss))
        updates, state = tx.update(g, state, params)
        params = optax.apply_updates(params, updates)

    net = FastKAN(dims, num_grids=8, use_base_update=False, fused=True,
                  compute_dtype=torch.bfloat16, device="cpu")
    net.load_state_dict(port.fastkan_from_jax(v))
    opt = torch.optim.Adam(net.parameters(), lr=1e-3)
    xt, yt, mt = torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(mask)
    losses_t, logits_t = [], None
    for _ in range(3):
        opt.zero_grad(set_to_none=True)
        logits = net(xt)
        logits_t = logits.detach() if logits_t is None else logits_t
        loss = masked_softmax_cross_entropy(logits, yt, mt)
        loss.backward()
        opt.step()
        losses_t.append(float(loss.detach()))
    close(logits_t, logits_j, "bf16", err_msg="logits")
    close(np.array(losses_t), np.array(losses_j), "bf16", err_msg="losses")
    assert losses_t[-1] < losses_t[0]


def test_cpu_wrappers_run_plain_and_count_no_launch(rng):
    fns = (rf.rbf_spline_fwd, rf.rbf_spline_bwd, spmm.sorted_segment_sum_narrow)
    before = [f.launches for f in fns]
    x, w = torch.randn(20, 4), torch.randn(32, 3)
    rf.rbf_spline_fwd(x, w, -2.0, 2.0)
    rf.rbf_spline_bwd(x, w, torch.ones(20, 3), -2.0, 2.0)
    spmm.sorted_segment_sum_narrow(torch.ones(6, 4),
                                   torch.tensor([0, 0, 1, 3, 3, 3], dtype=torch.int32), 4)
    assert [f.launches for f in fns] == before
