"""The arithmetic of the tensor-core RBF backward (csrc/rbf_fused.cu
`rbf_dx_mma_kernel`, `rbf_dw_mma_kernel`: w in bf16), emulated in torch on
the CPU, against the JAX `_bwd_kernel` of kagnn_tpu/pallas/rbf_fused.py in
interpret mode on the same numpy inputs.

The card multiplies bf16 operands exactly into f32 sums (mma.sync with f32
accumulators). The JAX kernel multiplies in f32: dbasis = dout @ W^T with W
in bf16 and dout in x's dtype, and dW = B^T @ dout with the f32 basis. So
the kernels split each f32 operand into bf16 terms (kan::split_terms: the
value rounded to bf16, then each rest rounded):
  * dx: an f32 dout as three terms (its value whole), a bf16 one as itself;
    each term times the bf16 W; then the basis derivative summed over the
    centers in x's rounding (`basis_plain`);
  * dW: the f32 basis as three terms, times dout as one term (bf16) or
    three (f32), of whose nine products the six hi*hi, hi*mid, mid*hi,
    hi*lo, mid*mid and lo*hi are taken (the other three are below 2^-24 of
    the product); each JAX row tile's f32 partial rounded to bf16 and added
    to the bf16 running sum in tile order.

Bars: dx in f32 rtol 1e-3 / atol 1e-5, in bf16 4 bf16 ulps of the output's
scale (tests/test_torch_rbf.py's gradient bars); dW over one row tile 4
bf16 ulps of its scale, over more the walk bar
(`kernels/selfcheck.py::dw_walk_check`, which the card's checks use: 8 ulps
of each element's running-sum peak, at most 1 % of the elements or 2
differing). `test_dx_takes_f32_dout_whole` shows that dout in one term,
rounded to bf16, fails dx's f32 bar where three terms meet it."""
import numpy as np
import pytest
import torch
from test_torch_rbf import DT, GRAD, _inputs, _jax_rbf, _np32

from kagnn_tpu_torch.kernels import rbf_fused as rf
from kagnn_tpu_torch.kernels._common import dw_tile, round_to
from kagnn_tpu_torch.kernels.fastkan_layer import inv_h
from kagnn_tpu_torch.kernels.selfcheck import DW_CLOSE_TILES, dw_walk_check

torch.set_num_threads(1)

BF16_ULP = 2.0 ** -8
GRID = (-2.0, 2.0)
# (basis term, dout term) products of an f32 dout (csrc/rbf_fused.cu
# pair_a/pair_b)
PAIRS = ((0, 0), (0, 1), (1, 0), (0, 2), (1, 1), (2, 0))
XW = [("f32", "bf16"), ("bf16", "bf16")]


def _terms(a32: torch.Tensor, n: int):
    """An f32 tensor as n bf16 terms, each returned in f32."""
    out = []
    for _ in range(n):
        t = a32.to(torch.bfloat16).float()
        out.append(t)
        a32 = a32 - t
    return out


def _dx_terms(x, w, dout, G, dout_terms):
    """rbf_dx_mma_kernel in torch: dbasis from dout's bf16 terms times the
    bf16 W (exact products, f32 sums), then sum_g ((dbasis_g * B_g) *
    (-2 inv_h)) * d_g in f32, cast to x's dtype."""
    n, D = x.shape
    c, ih = rf.constants(*GRID, G, x.dtype)
    b, d = rf.basis_plain(x, c, ih, round_exp=False)
    dbasis = sum(t @ w.float().T for t in _terms(dout.float(), dout_terms))
    wide = ((dbasis * b) * (-2.0 * inv_h(*GRID, G))) * d
    return sum(wide[:, g * D:(g + 1) * D] for g in range(G)).to(x.dtype)


def _dw_terms(x, dout, G, basis_terms=3):
    """rbf_dw_mma_kernel and the tile walk in torch: per JAX row tile the
    f32 partial of the basis terms times dout's terms (three products of a
    bf16 dout, the six PAIRS of an f32 one), rounded to bf16 and added to
    the bf16 running sum."""
    c, ih = rf.constants(*GRID, G, x.dtype)
    b, _ = rf.basis_plain(x, c, ih, round_exp=False)
    a = _terms(b, basis_terms)
    pairs = (PAIRS if dout.dtype == torch.float32
             else [(q, 0) for q in range(basis_terms)])
    dt = _terms(dout.float(), 3 if dout.dtype == torch.float32 else 1)
    tile = dw_tile(x.shape[0])
    walk = torch.zeros(b.shape[1], dout.shape[1])
    for r0 in range(0, x.shape[0], tile):
        rows = slice(r0, r0 + tile)
        part = sum(a[p][rows].T @ dt[q][rows] for p, q in pairs if p < basis_terms)
        walk = round_to(walk + round_to(part, torch.bfloat16), torch.bfloat16)
    return walk.to(torch.bfloat16), b, tile


def _dx_close(got, want, xd, name):
    got, want = _np32(got), _np32(want)
    if xd == "f32":
        np.testing.assert_allclose(got, want, err_msg=name, **GRAD)
    else:
        tol = 4 * BF16_ULP * max(float(np.abs(want).max()), 1e-6)
        assert float(np.abs(got - want).max()) <= tol, name


@pytest.mark.parametrize("G", [2, 8, 32])
@pytest.mark.parametrize("xw", XW, ids=["-".join(p) for p in XW])
def test_tensor_core_backward_matches_jax(rng, xw, G):
    """dx and dW of the term products against the JAX kernel at 2, 8 and 32
    centers over 1,300 rows (three 512-row tiles: the walk bar)."""
    xd, wd = xw
    (jx, jw, jd), (tx, tw, td) = _inputs(rng, 1300, 6, 5, G, xd, wd)
    _, dx_j, dw_j = _jax_rbf(jx, jw, jd, G)
    dx = _dx_terms(tx, tw, td, G, 3 if xd == "f32" else 1)
    assert dx.dtype == DT[xd][1]
    _dx_close(dx, dx_j, xd, "dx")
    dw, b, tile = _dw_terms(tx, td, G)
    want = torch.from_numpy(np.array(_np32(dw_j)))
    assert -(-tx.shape[0] // tile) > DW_CLOSE_TILES
    dw_walk_check(f"dw G={G} {xd}/{wd}", b, td.float(), tile, dw, want, log=lambda *_: None)


def test_dx_takes_f32_dout_whole(rng):
    """x f32 / w bf16 at 8 centers: dout split into three bf16 terms meets
    the JAX dx within the f32 bar; dout rounded to one bf16 term (about 2^-9
    of each value) does not."""
    G = 8
    (jx, jw, jd), (tx, tw, td) = _inputs(rng, 700, 8, 16, G, "f32", "bf16")
    _, dx_j, _ = _jax_rbf(jx, jw, jd, G)
    _dx_close(_dx_terms(tx, tw, td, G, 3), dx_j, "f32", "three terms")
    with pytest.raises(AssertionError):
        _dx_close(_dx_terms(tx, tw, td, G, 1), dx_j, "f32", "one term")


@pytest.mark.parametrize("G", [2, 32])
def test_one_tile_dw_meets_the_kernel_bar(rng, G):
    """Over one row tile (200 rows: a 256-row tile) the walked dW is one
    rounding of one partial and keeps the kernels' 4-ulp bar against JAX,
    for an f32 dout (the six products) and a bf16 one."""
    for xd in ("f32", "bf16"):
        (jx, jw, jd), (tx, tw, td) = _inputs(rng, 200, 6, 5, G, xd, "bf16")
        _, _, dw_j = _jax_rbf(jx, jw, jd, G)
        dw, _, tile = _dw_terms(tx, td, G)
        assert -(-tx.shape[0] // tile) == 1
        want = _np32(dw_j)
        tol = 4 * BF16_ULP * max(float(np.abs(want).max()), 1e-6)
        assert float(np.abs(_np32(dw) - want).max()) <= tol
