"""Kernel modules of the port (kagnn_tpu_torch/kernels/) against the JAX
Pallas kernels run in interpret mode, on the same numpy inputs.

On the CPU every wrapper runs its plain PyTorch version, so these tests hold
the plain versions (the arithmetic each CUDA kernel must reproduce) against
the TPU kernels. The CUDA kernels themselves are held against the plain
versions on the card by tests/test_torch_cuda.py and chip_smoke.py.

Tolerances:
  * f32 values rtol 1e-4 / atol 1e-5, gradients rtol 1e-3 / atol 1e-5: the
    same f32 arithmetic in another summation order. Where the JAX kernel
    sums through its one-hot MXU segment sum (spmm, gin_fused), the same
    rtol applies to the output's scale (max |jax|) instead of to each
    element: that kernel carries each f32 message as a bf16 hi/lo pair
    (kagnn_tpu/pallas/spmm.py `_split_hilo`, 16 significant bits), so its
    error follows the size of the summed terms, not of a sum that cancels;
  * bf16: max |port - jax| <= 4 bf16 ulps (4 * 2^-8) of the output's scale
    (max |jax|): both round the same f32 sums to bf16. The weight gradients
    follow the JAX backward's sum over its 128-row tiles, each tile's f32
    partial and the running sum rounded to bf16 (`_common.tiled_gram`);
    `test_bspline_bf16_dw_walks_the_jax_tiles` holds that walk over 40
    tiles to 1 unit of 2^-8 of the scale, which the f32 sum rounded once
    fails.
Valid rows only for the GIN kernel: its output at the masked last row is
unspecified (no edge-mask multiply, as in the JAX kernel)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kagnn_tpu.graphs import single_graph as jax_single_graph
from kagnn_tpu.kan import bspline as jbs
from kagnn_tpu.pallas.bspline_fused import bspline_kan_matmul
from kagnn_tpu.pallas.gin_fused import gin_kan_fused as jax_gin_kan_fused
from kagnn_tpu.pallas.spmm import sorted_segment_sum as jax_ssum
from kagnn_tpu_torch.graphs import single_graph
from kagnn_tpu_torch.kernels import bspline_fused as bf
from kagnn_tpu_torch.kernels import gin_fused as gf
from kagnn_tpu_torch.kernels import spmm

torch.set_num_threads(1)

VAL = dict(rtol=1e-4, atol=1e-5)
GRAD = dict(rtol=1e-3, atol=1e-5)
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _np32(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32)) if not \
        isinstance(a, torch.Tensor) else a.detach().float().numpy()


def close(got, want, dt, grad=False, err_msg="", scaled=False):
    got, want = _np32(got), _np32(want)
    if dt == "f32" and scaled:
        tol = (GRAD if grad else VAL)["rtol"] * float(np.abs(want).max())
        err = float(np.abs(got - want).max())
        assert err <= tol, f"{err_msg}: max err {err} > {tol}"
    elif dt == "f32":
        np.testing.assert_allclose(got, want, err_msg=err_msg,
                                   **(GRAD if grad else VAL))
    else:
        tol = 4 * 2.0 ** -8 * max(float(np.abs(want).max()), 1e-6)
        err = float(np.abs(got - want).max())
        assert err <= tol, f"{err_msg}: max err {err} > {tol}"


def _graphs(rng, n=50, e=300, f=8):
    snd, rcv = rng.integers(0, n, e), rng.integers(0, n, e)
    nodes = (rng.normal(size=(n, f)) * 0.5).astype(np.float32)
    return (jax_single_graph(snd, rcv, nodes=nodes),
            single_graph(snd, rcv, nodes=nodes, device="cpu"))


@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_spmm_matches_jax(rng, dt):
    jd, td = DTYPES[dt]
    gj, gt = _graphs(rng)
    msgs = rng.normal(size=(gt.n_edge_pad, 16)).astype(np.float32)
    want = jax_ssum(jnp.asarray(msgs, jd), gj.receivers, gj.n_node_pad, True)
    got = spmm.sorted_segment_sum(torch.from_numpy(msgs).to(td),
                                  gt.recv_row_ptr)
    assert got.dtype == td and got.shape == (gt.n_node_pad, 16)
    close(got, want, dt, scaled=True)


@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_spmm_gather_index_matches_jax(rng, dt):
    """A^T·dz as the GIN backward runs it: the gather index reads
    dz[receivers_by_sender[e]] over the sender CSR."""
    jd, td = DTYPES[dt]
    gj, gt = _graphs(rng)
    dz = rng.normal(size=(gt.n_node_pad, 12)).astype(np.float32)
    cot_e = jnp.take(jnp.asarray(dz, jd), gj.receivers_by_sender, axis=0)
    want = jax_ssum(cot_e, gj.senders_sorted, gj.n_node_pad, True)
    got = spmm.sorted_segment_sum(torch.from_numpy(dz).to(td),
                                  gt.send_row_ptr, gt.receivers_by_sender)
    close(got, want, dt, scaled=True)


def test_segment_sum_autograd_matches_jax_vjp(rng):
    gj, gt = _graphs(rng)
    msgs = rng.normal(size=(gt.n_edge_pad, 4)).astype(np.float32)
    cot = rng.normal(size=(gt.n_node_pad, 4)).astype(np.float32)
    out, vjp = jax.vjp(lambda m: jax_ssum(m, gj.receivers, gj.n_node_pad, True),
                       jnp.asarray(msgs))
    mt = torch.from_numpy(msgs).requires_grad_(True)
    ot = spmm.SortedSegmentSum.apply(mt, gt.recv_row_ptr)
    ot.backward(torch.from_numpy(cot))
    close(ot, out, "f32", scaled=True)
    close(mt.grad, vjp(jnp.asarray(cot))[0], "f32", grad=True)


def _layer(rng, d, o, g=4, k=3):
    grid = np.asarray(jbs.make_grid(d, g, k))
    wb = (rng.normal(size=(d, o)) * 0.3).astype(np.float32)
    ws = (rng.normal(size=(g + k, d, o)) * 0.3).astype(np.float32)
    return grid.T.copy(), wb, ws


@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_bspline_fused_fwd_bwd_matches_jax(rng, dt):
    """Forward and backward (dx, dWb, dWs) over two JAX row tiles."""
    jd, td = DTYPES[dt]
    n, d, o, k = 150, 8, 6, 3
    knots, wb, ws = _layer(rng, d, o)
    x = rng.normal(size=(n, d)).astype(np.float32)
    dout = rng.normal(size=(n, o)).astype(np.float32)
    jargs = [jnp.asarray(a, jd) for a in (x, knots, wb, ws)]
    out_j, vjp = jax.vjp(lambda x_, wb_, ws_: bspline_kan_matmul(
        x_, jargs[1], wb_, ws_, k, True), jargs[0], jargs[2], jargs[3])
    dx_j, dwb_j, dws_j = vjp(jnp.asarray(dout, jd))

    t = [torch.from_numpy(a).to(td) for a in (x, knots, wb, ws.reshape(-1, o))]
    out_t = bf.kan_linear_fwd(*t, k)
    dx_t, dwb_t, dws_t = bf.kan_linear_bwd(*t, torch.from_numpy(dout).to(td), k)
    assert out_t.dtype == td and dx_t.dtype == td
    close(out_t, out_j, dt, err_msg="out")
    close(dx_t, dx_j, dt, grad=True, err_msg="dx")
    close(dwb_t, dwb_j, dt, grad=True, err_msg="dwb")
    close(dws_t, np.asarray(dws_j.astype(jnp.float32)).reshape(-1, o), dt,
          grad=True, err_msg="dws")


def test_bspline_bf16_dw_walks_the_jax_tiles(rng):
    """5,083 rows are 40 tiles of 128: the JAX backward adds each tile's f32
    partial of dWb and dWs into the bf16 gradient, rounding the partial and
    the sum after every tile. The port walks the same tiles: every element
    of both gradients within 1 unit of 2^-8 (a bf16 ulp) of the gradient's
    scale (max |jax|), since both round the same f32 partials at the same
    points and only the partials' summation order differs (a flipped
    rounding moves an element by about one ulp of its running sum; none
    flips here). The same partials summed in f32 and rounded once, the
    port's sum before, are further away than that bar in both gradients."""
    n, d, o, k = 40 * 128 - 37, 8, 8, 3
    knots, wb, ws = _layer(rng, d, o)
    x = rng.normal(size=(n, d)).astype(np.float32)
    dout = rng.normal(size=(n, o)).astype(np.float32)
    jargs = [jnp.asarray(a, jnp.bfloat16) for a in (x, knots, wb, ws)]
    _, vjp = jax.vjp(lambda x_, wb_, ws_: bspline_kan_matmul(
        x_, jargs[1], wb_, ws_, k, True), jargs[0], jargs[2], jargs[3])
    _, dwb_j, dws_j = vjp(jnp.asarray(dout, jnp.bfloat16))
    t = [torch.tensor(_np32(a)).bfloat16()
         for a in (jargs[0], jargs[1], jargs[2], jargs[3].reshape(-1, o))]
    dt = torch.from_numpy(dout).bfloat16()
    _, dwb, dws = bf.kan_linear_bwd(*t, dt, k, need_dx=False)
    once = (bf.dw_operand(t[0], t[1], k).float().T @ dt.float()).bfloat16()
    for name, got, old, want in (("dwb", dwb, once[:d], dwb_j),
                                 ("dws", dws, once[d:], dws_j.reshape(-1, o))):
        want = _np32(want)
        unit = 2.0 ** -8 * np.abs(want).max()
        err = np.abs(_np32(got) - want).max()
        err_once = np.abs(_np32(old) - want).max()
        assert err <= unit < err_once, (name, err / unit, err_once / unit)


def test_bspline_autograd_function_uses_the_backward(rng):
    """BsplineKanMatmul's gradients are kan_linear_bwd's, and dx is skipped
    when x needs no gradient."""
    n, d, o, k = 40, 5, 3, 3
    knots, wb, ws = (torch.from_numpy(a) for a in _layer(rng, d, o))
    ws = ws.reshape(-1, o)
    x = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32))
    dout = torch.from_numpy(rng.normal(size=(n, o)).astype(np.float32))
    want = bf.kan_linear_bwd(x, knots, wb, ws, dout, k)
    xs, wbs, wss = (a.clone().requires_grad_(True) for a in (x, wb, ws))
    bf.BsplineKanMatmul.apply(xs, knots, wbs, wss, k).backward(dout)
    for got, w in zip((xs.grad, wbs.grad, wss.grad), want):
        torch.testing.assert_close(got, w, rtol=0, atol=0)
    wb2 = wb.clone().requires_grad_(True)
    bf.BsplineKanMatmul.apply(x, knots, wb2, ws, k).backward(dout)
    torch.testing.assert_close(wb2.grad, want[1], rtol=0, atol=0)
    assert bf.kan_linear_bwd(x, knots, wb, ws, dout, k, need_dx=False)[0] is None


@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_gin_fused_matches_jax(rng, dt):
    """gin_kan_fused with eps 0.25, values and gradients (dx, dWb, dWs) of a
    masked loss, against the JAX kernel in interpret mode."""
    jd, td = DTYPES[dt]
    f_in, f_out, gs, k, eps = 8, 6, 4, 3, 0.25
    gj, gt = _graphs(rng, n=40, e=160, f=f_in)
    x = (rng.normal(size=(gt.n_node_pad, f_in)) * 0.5).astype(np.float32)
    grid = np.array(jbs.make_grid(f_in, gs, k))
    wb = (rng.normal(size=(f_out, f_in)) * 0.3).astype(np.float32)
    ws = (rng.normal(size=(f_out, f_in, gs + k)) * 0.3).astype(np.float32)
    nm = gt.node_mask.numpy()
    w_out = rng.normal(size=(gt.n_node_pad, f_out)).astype(np.float32) * nm[:, None]

    def jloss(x_, wb_, ws_):
        o = jax_gin_kan_fused(x_, gj, eps, jnp.asarray(grid, jd), wb_, ws_, k,
                              interpret=True)
        return jnp.sum(o.astype(jnp.float32) * w_out), o

    jx = [jnp.asarray(a, jd) for a in (x, wb, ws)]
    (_, out_j), grads_j = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                             has_aux=True)(*jx)
    tx = [torch.from_numpy(a).to(td).requires_grad_(True) for a in (x, wb, ws)]
    out_t = gf.gin_kan_fused(tx[0], gt, eps, torch.from_numpy(grid).to(td),
                             tx[1], tx[2], k)
    (out_t.float() * torch.from_numpy(w_out)).sum().backward()
    close(out_t[gt.node_mask], np.asarray(out_j.astype(jnp.float32))[nm], dt,
          err_msg="out", scaled=True)
    for name, a, b in zip(("dx", "dwb", "dws"), tx, grads_j):
        ga, gb = a.grad.float().numpy(), np.asarray(b.astype(jnp.float32))
        if name == "dx":
            ga, gb = ga[nm], gb[nm]
        close(ga, gb, dt, grad=True, err_msg=name, scaled=True)


def test_gin_backward_skips_dx_when_x_needs_no_grad(rng):
    """The first conv's input (node features) needs no gradient: the
    backward then computes only the weight gradients, and no segment sum."""
    gj, gt = _graphs(rng, n=20, e=60, f=4)
    grid = torch.from_numpy(np.array(jbs.make_grid(4, 4, 3)))
    wb = torch.randn(3, 4, generator=torch.Generator().manual_seed(0),
                     requires_grad=True)
    ws = torch.randn(3, 4, 7, generator=torch.Generator().manual_seed(1),
                     requires_grad=True)
    calls = []
    orig = spmm.sorted_segment_sum_plain
    spmm.sorted_segment_sum_plain = lambda *a: calls.append(1) or orig(*a)
    try:
        gf.gin_kan_fused(gt.nodes, gt, 0.0, grid, wb, ws, 3).sum().backward()
    finally:
        spmm.sorted_segment_sum_plain = orig
    assert not calls and wb.grad is not None and ws.grad is not None


def test_cpu_wrappers_run_plain_and_count_no_launch(rng):
    gj, gt = _graphs(rng, n=20, e=60, f=4)
    before = (spmm.sorted_segment_sum.launches, bf.kan_linear_fwd.launches,
              bf.kan_linear_bwd.launches, gf.gin_kan_fwd.launches)
    knots, wb, ws = (torch.from_numpy(a) for a in _layer(rng, 4, 3))
    ws = ws.reshape(-1, 3)
    x = gt.nodes
    spmm.sorted_segment_sum(x, gt.send_row_ptr, gt.receivers_by_sender)
    bf.kan_linear_fwd(x, knots, wb, ws, 3)
    bf.kan_linear_bwd(x, knots, wb, ws, torch.ones(x.shape[0], 3), 3)
    gf.gin_kan_fwd(x, gt.senders, gt.recv_row_ptr, knots, wb, ws, 3, 0.0)
    assert before == (spmm.sorted_segment_sum.launches,
                      bf.kan_linear_fwd.launches, bf.kan_linear_bwd.launches,
                      gf.gin_kan_fwd.launches)
