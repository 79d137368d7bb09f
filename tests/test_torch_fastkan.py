"""The port's FastKAN pieces against the JAX package on the same numpy
inputs: `kan/rbf.py`, the FastKANLayer kernel module
(kernels/fastkan_layer.py) against `pallas/fastkan_layer.py` in interpret
mode, the GIN+FastKAN kernel module (kernels/gin_fastkan.py) against
`pallas/gin_fastkan.py` in interpret mode, and the `FastKANLayer` /
`FastKAN` / `GINConv` modules against the JAX `fused=False` path.

On the CPU every wrapper runs its plain PyTorch version, so these tests hold
the plain versions (the arithmetic each CUDA kernel must reproduce) against
the TPU kernels; tests/test_torch_cuda.py and chip_smoke.py hold the CUDA
kernels against the plain versions on the card.

Tolerances:
  * f32 values rtol 1e-4 / atol 1e-5, gradients rtol 1e-3 / atol 1e-5: the
    same f32 arithmetic in another summation order. Against the JAX GIN
    kernel, whose one-hot MXU segment sum carries each f32 message as a
    bf16 hi/lo pair (16 significant bits), the rtol applies to the output's
    scale (max |jax|) instead of to each element;
  * bf16: max |port - jax| <= 4 bf16 ulps (4 * 2^-8) of the output's scale:
    both round the same f32 sums to bf16. The five weight gradients follow
    the JAX backward's sum over its row tiles (`_common.dw_tile`), each
    tile's f32 partial and the running sum rounded to bf16;
    `test_fastkan_bf16_weight_grads_walk_the_jax_tiles` holds that walk
    over 40 tiles to 1 unit of 2^-8 of the scale, which the f32 sum rounded
    once fails.
Valid rows only for the GIN kernel: its output at the masked last row is
unspecified (no edge-mask multiply, as in the JAX kernel)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kagnn_tpu.graphs import single_graph as jax_single_graph
from kagnn_tpu.kan import rbf as jrbf
from kagnn_tpu.kan.layers import FastKAN as JFastKAN
from kagnn_tpu.kan.layers import FastKANLayer as JFastKANLayer
from kagnn_tpu.nn.convs import GINConv as JGINConv
from kagnn_tpu.ops import segment as jsegment
from kagnn_tpu.pallas.fastkan_layer import \
    fastkan_layer_fused as jax_fastkan_layer
from kagnn_tpu.pallas.gin_fastkan import gin_fastkan_fused as jax_gin_fastkan
from kagnn_tpu_torch.graphs import single_graph
from kagnn_tpu_torch.kan import FastKAN, FastKANLayer, rbf
from kagnn_tpu_torch.kernels import fastkan_layer as fk
from kagnn_tpu_torch.kernels import gin_fastkan as gfk
from kagnn_tpu_torch.kernels import spmm
from kagnn_tpu_torch.nn import GINConv
from kagnn_tpu_torch.ops import segment as segment_ops

torch.set_num_threads(1)

VAL = dict(rtol=1e-4, atol=1e-5)
GRAD = dict(rtol=1e-3, atol=1e-5)
BF16_ULP = 2.0 ** -8
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
GRADS = ("dx", "dlng", "dlnb", "dsw", "dwb", "dbb")


def _np32(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def close(got, want, dt, grad=False, err_msg="", scaled=False):
    got, want = _np32(got), _np32(want)
    if dt == "f32" and not scaled:
        np.testing.assert_allclose(got, want, err_msg=err_msg,
                                   **(GRAD if grad else VAL))
        return
    c = (GRAD if grad else VAL)["rtol"] if dt == "f32" else 4 * BF16_ULP
    tol = c * max(float(np.abs(want).max()), 1e-6)
    err = float(np.abs(got - want).max())
    assert err <= tol, f"{err_msg}: max err {err} > {tol}"


def _layer_weights(rng, d, o, G):
    """ln scale/bias (D,), spline weight (O, D*G), base weight (O, D),
    base bias (O,) in the module layouts."""
    return [(rng.normal(size=(d,)) * 0.2 + 1.0).astype(np.float32),
            (rng.normal(size=(d,)) * 0.1).astype(np.float32),
            (rng.normal(size=(o, d * G)) * 0.3).astype(np.float32),
            (rng.normal(size=(o, d)) * 0.3).astype(np.float32),
            (rng.normal(size=(o,)) * 0.1).astype(np.float32)]


def _graphs(rng, n=40, e=160, f=8):
    snd, rcv = rng.integers(0, n, e), rng.integers(0, n, e)
    nodes = (rng.normal(size=(n, f)) * 0.5).astype(np.float32)
    return (jax_single_graph(snd, rcv, nodes=nodes),
            single_graph(snd, rcv, nodes=nodes, device="cpu"))


@pytest.mark.parametrize("G", [2, 4, 8])
def test_rbf_basis_matches_jax(rng, G):
    x = rng.normal(size=(30, 5)).astype(np.float32) * 2
    np.testing.assert_allclose(rbf.make_rbf_grid(-2.0, 2.0, G).numpy(),
                               np.asarray(jrbf.make_rbf_grid(-2.0, 2.0, G)),
                               rtol=1e-6, atol=1e-6)
    denom = 4.0 / (G - 1)
    want = jrbf.rbf_basis(jnp.asarray(x), jrbf.make_rbf_grid(-2.0, 2.0, G),
                          denom)
    got = rbf.rbf_basis(torch.from_numpy(x), rbf.make_rbf_grid(-2.0, 2.0, G),
                        denom)
    assert got.shape == (30, 5, G)
    close(got, want, "f32")


@pytest.mark.parametrize("G", [4, 7])
@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_fastkan_layer_fwd_and_six_grads_match_jax(rng, dt, G):
    """The whole layer and its VJP (dx, dlng, dlnb, dW, dWb, dbb) through
    the module layouts, against the JAX kernel in interpret mode."""
    jd, td = DTYPES[dt]
    n, d, o = 150, 12, 6
    x = rng.normal(size=(n, d)).astype(np.float32)
    x[7] = 0.0  # a row of zeros: variance 0, rstd finite
    dout = rng.normal(size=(n, o)).astype(np.float32)
    ws = _layer_weights(rng, d, o, G)
    jargs = [jnp.asarray(a, jd) for a in [x] + ws]
    out_j, vjp = jax.vjp(lambda *a: jax_fastkan_layer(
        *a, -2.0, 2.0, G, 4.0 / (G - 1), interpret=True), *jargs)
    grads_j = vjp(jnp.asarray(dout, jd))

    targs = [torch.from_numpy(a).to(td).requires_grad_(True) for a in [x] + ws]
    out_t = fk.fastkan_layer_fused(*targs, -2.0, 2.0, G)
    out_t.backward(torch.from_numpy(dout).to(td))
    assert out_t.dtype == td
    close(out_t, out_j, dt, err_msg="out")
    for name, a, b in zip(GRADS, targs, grads_j):
        assert a.grad.dtype == td and torch.isfinite(a.grad).all()
        close(a.grad, b, dt, grad=True, err_msg=name)


def test_fastkan_kernel_keeps_the_basis_in_f32(rng):
    """The JAX kernel multiplies the f32 basis with the bf16 spline weight
    in f32 (it does not round the basis to bf16 first, unlike the B-spline
    kernel): the port's plain version, which keeps the basis in f32, meets
    the JAX bf16 output bit for bit on more elements than a variant that
    rounds the basis."""
    n, d, o, G = 64, 16, 8, 4
    x = rng.normal(size=(n, d)).astype(np.float32)
    ws = _layer_weights(rng, d, o, G)
    want = _np32(jax_fastkan_layer(*[jnp.asarray(a, jnp.bfloat16)
                                     for a in [x] + ws],
                                   -2.0, 2.0, G, 4.0 / (G - 1),
                                   interpret=True))
    t = fk.weight_layouts(*[torch.from_numpy(a).to(torch.bfloat16)
                            for a in ws], G)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    f32_basis = _np32(fk.fastkan_layer_fwd(xb, *t, -2.0, 2.0))
    lng, lnb, w, wb, bb = t
    xhat, _ = fk.layer_norm_f32(xb.float())
    basis, _ = fk.wide_basis(xhat * lng.float() + lnb.float(),
                             torch.from_numpy(fk.centers(-2.0, 2.0, G)),
                             fk.inv_h(-2.0, 2.0, G))
    x32 = xb.float()
    rounded = _np32((basis.to(torch.bfloat16).float() @ w.float()
                     + (x32 * torch.sigmoid(x32)) @ wb.float()
                     + bb.float()).to(torch.bfloat16))
    assert (f32_basis != want).sum() < (rounded != want).sum()


def test_fastkan_bf16_weight_grads_walk_the_jax_tiles(rng):
    """20,380 rows are 40 tiles of 512: the JAX backward adds each tile's
    f32 partial of dlng, dlnb, dW, dWb and dbb into the bf16 gradient,
    rounding the partial and the sum after every tile. The port walks the
    same tiles: every element within 1 unit of 2^-8 (a bf16 ulp) of its
    gradient's scale (max |jax|), since both round the same f32 partials at
    the same points and only the partials' summation order differs (a
    flipped rounding moves an element by about one ulp of its running sum;
    none flips here). The same partials summed in f32 and rounded once, the
    port's sum before, are further away than that bar in all five."""
    n, d, o, G = 40 * 512 - 100, 4, 4, 4
    ws = _layer_weights(rng, d, o, G)
    x = rng.normal(size=(n, d)).astype(np.float32)
    dout = rng.normal(size=(n, o)).astype(np.float32)
    jargs = [jnp.asarray(a, jnp.bfloat16) for a in [x] + ws]
    _, vjp = jax.vjp(lambda *a: jax_fastkan_layer(
        *a, -2.0, 2.0, G, 4.0 / (G - 1), interpret=True), *jargs)
    grads_j = vjp(jnp.asarray(dout, jnp.bfloat16))
    xt, *mod = [torch.tensor(_np32(a)).bfloat16() for a in jargs]
    lng, lnb, w, wb, _ = fk.weight_layouts(*mod, G)
    dt = torch.from_numpy(dout).bfloat16()
    got = fk.fastkan_layer_bwd(xt, lng, lnb, w, wb, dt, -2.0, 2.0,
                               need_dx=False)[1:]
    _, terms = fk.fastkan_bwd_terms(xt, lng, lnb, w, dt, -2.0, 2.0)
    # the port's layouts -> the module's: dW (G*D, O) -> (O, D*G), dWb (D, O)
    # -> (O, D)
    to_module = (lambda v: v.reshape(-1), lambda v: v.reshape(-1),
                 lambda v: v.reshape(G, d, o).permute(2, 1, 0).reshape(o, d * G),
                 lambda v: v.T, lambda v: v.reshape(-1))
    for name, g, (a, b), f, want in zip(("dlng", "dlnb", "dw", "dwb", "dbb"),
                                        got, terms, to_module, grads_j[1:]):
        want = _np32(want)
        unit = BF16_ULP * np.abs(want).max()
        err = np.abs(_np32(f(g)) - want).max()
        err_once = np.abs(_np32(f((a.T @ b).bfloat16())) - want).max()
        assert err <= unit < err_once, (name, err / unit, err_once / unit)


def test_dw_tile_is_the_jax_row_tile():
    """The row tile of the port's weight-gradient walks is the JAX
    backward's `_tile_for`, for the FastKAN and RBF backwards' 512 and the
    forward's 1024."""
    from kagnn_tpu.pallas.rbf_fused import _tile_for
    from kagnn_tpu_torch.kernels._common import dw_tile

    for tile in (512, 1024):
        for n in (0, 1, 127, 128, 255, 256, 257, 511, 512, 513, 169344):
            assert dw_tile(n, tile) == _tile_for(n, tile), (n, tile)


@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_gin_fastkan_matches_jax(rng, dt):
    """gin_fastkan_fused with eps 0.25: value and the six gradients of a
    masked loss, against the JAX kernel in interpret mode."""
    jd, td = DTYPES[dt]
    f_in, f_out, G, eps = 8, 6, 4, 0.25
    gj, gt = _graphs(rng, f=f_in)
    x = (rng.normal(size=(gt.n_node_pad, f_in)) * 0.5).astype(np.float32)
    ws = _layer_weights(rng, f_in, f_out, G)
    nm = gt.node_mask.numpy()
    w_out = rng.normal(size=(gt.n_node_pad, f_out)).astype(np.float32) * nm[:, None]

    def jloss(*a):
        o = jax_gin_fastkan(a[0], gj, eps, *a[1:], -2.0, 2.0, G, 4.0 / (G - 1),
                            interpret=True)
        return jnp.sum(o.astype(jnp.float32) * w_out), o

    jx = [jnp.asarray(a, jd) for a in [x] + ws]
    (_, out_j), grads_j = jax.value_and_grad(
        jloss, argnums=tuple(range(6)), has_aux=True)(*jx)
    tx = [torch.from_numpy(a).to(td).requires_grad_(True) for a in [x] + ws]
    out_t = gfk.gin_fastkan_fused(tx[0], gt, eps, *tx[1:], -2.0, 2.0, G)
    (out_t.float() * torch.from_numpy(w_out)).sum().backward()
    close(out_t[gt.node_mask], _np32(out_j)[nm], dt, err_msg="out",
          scaled=True)
    for name, a, b in zip(GRADS, tx, grads_j):
        ga, gb = a.grad.float().numpy(), _np32(b)
        if name == "dx":
            ga, gb = ga[nm], gb[nm]
        close(ga, gb, dt, grad=True, err_msg=name, scaled=True)


def test_gin_fastkan_backward_skips_dx_when_x_needs_no_grad(rng):
    """The first conv's input needs no gradient: the backward then computes
    only the weight gradients, and no segment sum."""
    gj, gt = _graphs(rng, n=20, e=60, f=4)
    ws = [torch.from_numpy(a).requires_grad_(True)
          for a in _layer_weights(rng, 4, 3, 4)]
    calls = []
    orig = spmm.sorted_segment_sum_plain
    spmm.sorted_segment_sum_plain = lambda *a: calls.append(1) or orig(*a)
    try:
        gfk.gin_fastkan_fused(gt.nodes, gt, 0.0, *ws, -2.0, 2.0, 4).sum().backward()
    finally:
        spmm.sorted_segment_sum_plain = orig
    assert not calls and all(w.grad is not None for w in ws)


def _load_layer(layer, params):
    sd = {"spline_linear.weight": params["spline_weight"],
          "base_linear.weight": params["base_weight"],
          "base_linear.bias": params["base_bias"],
          "layernorm.weight": params["layernorm"]["scale"],
          "layernorm.bias": params["layernorm"]["bias"]}
    layer.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in sd.items()})


@pytest.mark.parametrize("fused", [False, True])
def test_fastkan_layer_module_matches_jax(rng, fused):
    """Port FastKANLayer (plain autograd path, and the fused wrappers'
    plain versions) against JAX fused=False, values and all gradients."""
    n, fin, fout, G = 33, 6, 5, 4
    x = rng.normal(size=(n, fin)).astype(np.float32)
    t = rng.normal(size=(n, fout)).astype(np.float32)
    jm = JFastKANLayer(fin, fout, num_grids=G)
    v = jm.init(jax.random.key(0), jnp.asarray(x))

    def jloss(params, x_):
        return jnp.sum((jm.apply({"params": params}, x_) - t) ** 2)

    gp, gx = jax.grad(jloss, argnums=(0, 1))(v["params"], jnp.asarray(x))
    m = FastKANLayer(fin, fout, num_grids=G, fused=fused, device="cpu")
    _load_layer(m, v["params"])
    xt = torch.from_numpy(x).requires_grad_(True)
    out = m(xt)
    close(out, jm.apply(v, jnp.asarray(x)), "f32")
    ((out - torch.from_numpy(t)) ** 2).sum().backward()
    close(xt.grad, gx, "f32", grad=True, err_msg="dx")
    want = {"spline_linear.weight": gp["spline_weight"],
            "base_linear.weight": gp["base_weight"],
            "base_linear.bias": gp["base_bias"],
            "layernorm.weight": gp["layernorm"]["scale"],
            "layernorm.bias": gp["layernorm"]["bias"]}
    for name, p in m.named_parameters():
        close(p.grad, want[name], "f32", grad=True, err_msg=name)


def test_fastkan_layer_init_draws_from_the_generator():
    """Spline weight: a truncated normal on [-2, 2] times 0.1; base weight
    and bias: U(-1/sqrt(in), 1/sqrt(in)); the same generator seed gives the
    same weights, and the layer needs more than one input feature."""
    def make(seed):
        return FastKANLayer(16, 8, num_grids=4, device="cpu",
                            generator=torch.Generator().manual_seed(seed))
    a, b, c = make(0), make(0), make(1)
    assert a.spline_linear.weight.shape == (8, 64)
    assert a.spline_linear.weight.abs().max() <= 0.2
    assert a.base_linear.weight.abs().max() <= 0.25
    assert a.base_linear.bias.abs().max() <= 0.25
    assert torch.equal(a.spline_linear.weight, b.spline_linear.weight)
    assert not torch.equal(a.spline_linear.weight, c.spline_linear.weight)
    with pytest.raises(ValueError, match="1D inputs"):
        FastKANLayer(1, 4, device="cpu")


@pytest.mark.parametrize("fused", [False, True])
def test_ginconv_fastkan_matches_jax(rng, fused):
    """GINConv(FastKAN([8, 16, 6])): value and every parameter gradient
    against the JAX unfused module (the port's fused path runs the segment
    sum's and the layer kernels' plain versions on the CPU)."""
    gj, gt = _graphs(rng, f=8)
    x = (rng.normal(size=(gt.n_node_pad, 8)) * 0.5).astype(np.float32)
    nm = gt.node_mask.numpy()
    jm = JGINConv(JFastKAN([8, 16, 6], num_grids=4))
    with jsegment.use_pallas_spmm(False):
        v = jm.init(jax.random.key(0), gj, jnp.asarray(x))

        def jloss(params):
            o = jm.apply({"params": params}, gj, jnp.asarray(x))
            return jnp.sum(jnp.where(gj.node_mask[:, None], o * jnp.cos(o), 0.0)), o

        (_, out_j), gp = jax.value_and_grad(jloss, has_aux=True)(v["params"])
    m = GINConv(FastKAN([8, 16, 6], num_grids=4, fused=fused, device="cpu"),
                fused=fused)
    for j in range(2):
        _load_layer(m.update.layers[j], v["params"]["update"][f"layers_{j}"])
    out = m(gt, torch.from_numpy(x))
    close(out[gt.node_mask], np.asarray(out_j)[nm], "f32")
    torch.where(gt.node_mask[:, None], out * torch.cos(out),
                torch.zeros(())).sum().backward()
    for j, layer in enumerate(m.update.layers):
        p = gp["update"][f"layers_{j}"]
        want = {"spline_linear.weight": p["spline_weight"],
                "base_linear.weight": p["base_weight"],
                "base_linear.bias": p["base_bias"],
                "layernorm.weight": p["layernorm"]["scale"],
                "layernorm.bias": p["layernorm"]["bias"]}
        for name, q in layer.named_parameters():
            close(q.grad, want[name], "f32", grad=True, err_msg=f"{j}.{name}")


@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_fused_neighbor_sum_matches_jax_kernel(rng, dt):
    """neighbor_sum(fused=True), the segment sum forward and Aᵀ·cot
    backward that GINConv runs for a FastKAN net, against the JAX
    `neighbor_sum` with the edge-mask weight on its kernel route
    (`_neighbor_sum_sorted`, interpret mode). The pad row holds zeros, as
    at every layer of the model, so the mask weight the port drops
    multiplies nothing; the cotangent is zero there, as BatchNorm makes
    it."""
    jd, td = DTYPES[dt]
    gj, gt = _graphs(rng, f=8)
    nm = gt.node_mask.numpy()
    x = (rng.normal(size=(gt.n_node_pad, 8)) * nm[:, None]).astype(np.float32)
    cot = (rng.normal(size=x.shape) * nm[:, None]).astype(np.float32)
    with jsegment.use_pallas_spmm(True, interpret=True):
        out_j, vjp = jax.vjp(lambda a: jsegment.neighbor_sum(
            a, gj, edge_weight=gj.edge_mask.astype(jd),
            w_by_sender=gj.edge_mask_by_sender.astype(jd)),
            jnp.asarray(x, jd))
        (dx_j,) = vjp(jnp.asarray(cot, jd))
    xt = torch.from_numpy(x).to(td).requires_grad_(True)
    out_t = segment_ops.neighbor_sum(xt, gt, fused=True)
    out_t.backward(torch.from_numpy(cot).to(td))
    assert out_t.dtype == td and xt.grad.dtype == td
    close(out_t, out_j, dt, err_msg="out", scaled=True)
    close(xt.grad, dx_j, dt, grad=True, err_msg="dx", scaled=True)
    with pytest.raises(ValueError, match="edge weight"):
        segment_ops.neighbor_sum(xt, gt, edge_weight=gt.edge_mask.float(),
                                 fused=True)


def test_fastkan_layer_bf16_module_matches_jax(rng):
    """FastKANLayer under a bf16 compute dtype, unfused, against the JAX
    fused=False layer: both cast x and the spline and base weights to bf16,
    run the LayerNorm in f32 and return f32. Values within 4 bf16 ulps
    (4 * 2^-8) of the output's scale."""
    n, fin, fout, G = 33, 6, 5, 4
    x = rng.normal(size=(n, fin)).astype(np.float32)
    jm = JFastKANLayer(fin, fout, num_grids=G, compute_dtype=jnp.bfloat16)
    v = jm.init(jax.random.key(1), jnp.asarray(x))
    want = jm.apply(v, jnp.asarray(x))
    m = FastKANLayer(fin, fout, num_grids=G, compute_dtype=torch.bfloat16,
                     device="cpu")
    _load_layer(m, v["params"])
    got = m(torch.from_numpy(x))
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    close(got, want, "bf16")


def test_cpu_wrappers_run_plain_and_count_no_launch(rng):
    gj, gt = _graphs(rng, n=20, e=60, f=4)
    fns = (fk.fastkan_layer_fwd, fk.fastkan_layer_bwd, gfk.gin_fastkan_fwd)
    before = [f.launches for f in fns]
    t = fk.weight_layouts(*[torch.from_numpy(a)
                            for a in _layer_weights(rng, 4, 3, 4)], 4)
    x = gt.nodes
    fk.fastkan_layer_fwd(x, *t, -2.0, 2.0)
    fk.fastkan_layer_bwd(x, *t[:4], torch.ones(x.shape[0], 3), -2.0, 2.0)
    gfk.gin_fastkan_fwd(x, gt.senders, gt.recv_row_ptr, *t, 0.0, -2.0, 2.0)
    assert [f.launches for f in fns] == before
