"""The fused GIN aggregate + KANLinear (`kernels/gin_fused.py`) on receiver
rows far longer than the rest, on the CPU.

The graph is test_torch_spmm_hub.py's (`_hub_graph`): node 0 receives 2,500
edges, nodes 1-3 receive 63, 64 and 65 (one short of the 64-edge piece, one
piece, one past it), light edges over nodes 5-199, isolated nodes, and
padding to a multiple of 1,024 edges, which the pad row holds (heavy by its
padding: the GIN kernel has no edge mask).

On it, in f32 and bf16 at D 64 and 128 and at two (spline order, grid
size) shapes:
  * the plain version (`gin_kan_fwd_plain`, what the wrapper runs on a CPU
    tensor) against the JAX kernel (`kagnn_tpu/pallas/gin_fused.py::
    _fwd_impl`) in interpret mode, as the JAX package's tests run it, out
    and z of every row (the pad row's too: both sum its padded edges);
  * the CUDA kernel's design (csrc/gin_fused.cu) computed in torch step by
    step: the aggregate as kan_common.cuh's split row sum (a row of at most
    64 edges whole in edge order; a heavier row cut at the 64-edge chunks of
    the edge array, each piece summed by 4 lane groups taking every 4th edge
    and met in a butterfly, the pieces added in chunk order;
    test_torch_spmm_hub.py's `_split_sum32`), plus (1+eps)*x, as the f32 z;
    z rounded once to x's dtype; then the KANLinear on the unrounded f32 z,
    its basis rounded to x's dtype and multiplied chunk by chunk of features
    into f32 sums (the tensor-core forward's chunks under bf16), rounded
    once. It meets the JAX kernel within the same bars as the plain
    version;
  * the schedule: every edge summed exactly once, by its light row's lane
    group or in one piece of its heavy row, and every heavy row (node 0,
    node 3, the pad row) combined once.

Bars (tests/test_torch_kernels.py's for the GIN kernel): f32 1e-4 of the
output's scale (max |jax|: the JAX kernel's segment sum carries f32
messages as bf16 hi/lo pairs), bf16 4 bf16 ulps of the output's scale."""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_kernels import DTYPES, close
from test_torch_spmm_hub import PIECE, _hub_graph, _schedule, _split_sum32

from kagnn_tpu.kan import bspline as jbs
from kagnn_tpu.pallas.gin_fused import _fwd_impl
from kagnn_tpu.pallas.spmm import gather_rows_padded
from kagnn_tpu_torch.kernels import gin_fused as gf
from kagnn_tpu_torch.kernels.bspline_fused import basis_ladder

torch.set_num_threads(1)

EPS, O = 0.25, 64
SHAPES = ((3, 4), (4, 16))  # (spline order, grid size): the main paths', the largest
# features a chunk of the tensor-core forward (mma_common.cuh FwdChunk at
# 128 basis columns): 16 at 8 groups a feature, 8 at the 21 of (4, 16)
FWD_FEATURES = {8: 16, 21: 8}


@functools.cache
def _case(dt, D, shape):
    """(port graph, numpy inputs, JAX out and z as float32 numpy)."""
    jd, _ = DTYPES[dt]
    k, gs = shape
    gj, gt = _hub_graph()
    rng = np.random.default_rng(D + 10 * k + gs)
    x = (rng.normal(size=(gt.n_node_pad, D)) * 0.5).astype(np.float32)
    knots = np.array(jbs.make_grid(D, gs, k)).T.copy()  # (K, D)
    wb = (rng.normal(size=(D, O)) * 0.3).astype(np.float32)
    ws = (rng.normal(size=((gs + k) * D, O)) * 0.3).astype(np.float32)
    xj = jnp.asarray(x, jd)
    out, z = _fwd_impl(gather_rows_padded(xj, gj.senders), gj.receivers, xj, EPS,
                       jnp.asarray(knots, jd), jnp.asarray(wb, jd),
                       jnp.asarray(ws, jd).reshape(gs + k, D, O), k, True)
    want = [np.asarray(v.astype(jnp.float32)) for v in (out, z)]
    return gt, dict(x=x, knots=knots, wb=wb, ws=ws), want


def _split_forward(x, g, knots, wb, ws, k):
    """csrc/gin_fused.cu's two passes in torch: the split aggregate plus
    (1+eps)*x as the f32 z, z rounded once; the KANLinear on the f32 z,
    chunk by chunk of features. Returns (out, z)."""
    z32 = _split_sum32(x, g.recv_row_ptr, g.senders) + (1.0 + EPS) * x.float()
    bases, _ = basis_ladder(z32, knots.float(), k)
    groups = [z32 * torch.sigmoid(z32)] + bases  # (N, D) each, as the JAX kernel's
    D = x.shape[1]
    fc = FWD_FEATURES[len(groups)]
    acc = torch.zeros(x.shape[0], wb.shape[1])
    for d0 in range(0, D, fc):
        cols = slice(d0, min(d0 + fc, D))
        a = torch.cat([g_[:, cols] for g_ in groups], 1).to(x.dtype).float()
        w = torch.cat([wb[cols]] + [ws[i * D:(i + 1) * D][cols] for i in range(len(bases))])
        acc += a @ w.float()
    return acc.to(x.dtype), z32.to(x.dtype)


def test_split_schedule_sums_every_edge_once():
    """Over the receiver CSR every edge is summed exactly once: in its light
    row whole, or in one piece of its heavy row; the heavy rows are node 0,
    node 3 (65 edges) and the pad row (heavy by its padding), each combined
    once from pieces of its own."""
    _, gt = _hub_graph()
    rp = gt.recv_row_ptr.numpy().astype(np.int64)
    deg = np.diff(rp)
    heavy = set(np.nonzero(deg > PIECE)[0].tolist())
    assert heavy == {0, 3, gt.n_node_pad - 1}
    slots, combines = _schedule(gt.recv_row_ptr)
    assert set(combines) == heavy
    seen = np.zeros(int(rp[-1]), np.int64)
    for row in np.nonzero(deg <= PIECE)[0]:
        seen[rp[row]:rp[row + 1]] += 1
    for row, keys in combines.items():
        for key in keys:
            r, lo, hi = slots[key]
            assert r == row
            seen[lo:hi] += 1
    np.testing.assert_array_equal(seen, 1)


@pytest.mark.parametrize("shape", SHAPES, ids=[f"{k}-{g}" for k, g in SHAPES])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_plain_and_split_match_jax(dt, D, shape):
    """out and z of the plain version and of the split two-pass design, on
    the same inputs, against the JAX kernel; the split against the plain
    version within the same bar."""
    _, td = DTYPES[dt]
    g, x, want = _case(dt, D, shape)
    k = shape[0]
    xt, knots, wb, ws = (torch.from_numpy(x[n]).to(td) for n in ("x", "knots", "wb", "ws"))
    plain = gf.gin_kan_fwd(xt, g.senders, g.recv_row_ptr, knots, wb, ws, k, EPS)
    split = _split_forward(xt, g, knots, wb, ws, k)
    for name, p, s, w in zip(("out", "z"), plain, split, want):
        assert p.dtype == s.dtype == td
        close(p, w, dt, scaled=True, err_msg=f"plain {name}")
        close(s, w, dt, scaled=True, err_msg=f"split {name}")
        close(s, p, dt, scaled=True, err_msg=f"split vs plain {name}")
