"""The arithmetic of the tensor-core layer forwards (csrc/mma_common.cuh,
csrc/bspline_fused.cu `bspline_fwd_mma_kernel`, csrc/fastkan_layer.cu
`fastkan_fwd_mma_kernel`), emulated in torch on the CPU, against the JAX
Pallas kernels in interpret mode on the same numpy inputs.

The card multiplies bf16 operands exactly into f32 sums (mma.sync with f32
accumulators). The B-spline forward's operands are already bf16: the JAX
kernel casts SiLU(x) and the bases to the compute dtype before its product,
and so does the plain version the card is checked against
(`kan_linear_fwd_plain`). The FastKAN forward keeps its basis and SiLU(x) in
f32 (`jnp.dot(f32 basis, W)`); the kernel splits each f32 value into bf16
terms (two, hi + lo, about 2^-17 of the value, up to 8 centers; three, the
value whole, past 8) and sums their products.

Tolerance: bf16 outputs within 4 bf16 ulps (4 * 2^-8) of the output's scale
(max |jax|), the bar of the kernels' other CPU tests: both round the same
f32 sums to bf16 once, in another summation order."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kagnn_tpu.kan import bspline as jbs
from kagnn_tpu.pallas.bspline_fused import bspline_kan_matmul
from kagnn_tpu.pallas.fastkan_layer import \
    fastkan_layer_fused as jax_fastkan_layer
from kagnn_tpu_torch.kernels import bspline_fused as bf
from kagnn_tpu_torch.kernels import fastkan_layer as fk

torch.set_num_threads(1)

BF16_ULP = 2.0 ** -8


def _np32(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _errors(got, want):
    """(max |got - want| over the output's scale max |want|, mean |got -
    want| over the same scale, share of elements that differ)."""
    got, want = _np32(got), _np32(want)
    scale = max(float(np.abs(want).max()), 1e-6)
    diff = np.abs(got - want)
    return float(diff.max()) / scale, float(diff.mean()) / scale, float((diff > 0).mean())


def _terms(a32: torch.Tensor, n: int):
    """An f32 tensor as n bf16 terms (kan::split_terms): the value rounded
    to bf16, then each rest rounded; returned in f32."""
    out = []
    for _ in range(n):
        t = a32.to(torch.bfloat16).float()
        out.append(t)
        a32 = a32 - t
    return out


def _fastkan_case(rng, n, d, o, G):
    """bf16 inputs of one layer (module layouts, numpy) and the JAX
    kernel's output in interpret mode."""
    x = rng.normal(size=(n, d)).astype(np.float32)
    x[3] = 0.0  # a row of zeros: variance 0
    ws = [(rng.normal(size=(d,)) * 0.2 + 1.0).astype(np.float32),
          (rng.normal(size=(d,)) * 0.1).astype(np.float32),
          (rng.normal(size=(o, d * G)) * 0.3).astype(np.float32),
          (rng.normal(size=(o, d)) * 0.3).astype(np.float32),
          (rng.normal(size=(o,)) * 0.1).astype(np.float32)]
    want = jax_fastkan_layer(*[jnp.asarray(a, jnp.bfloat16) for a in [x] + ws],
                             -2.0, 2.0, G, 4.0 / (G - 1), interpret=True)
    t = [torch.from_numpy(a).to(torch.bfloat16) for a in [x] + ws]
    return t[0], fk.weight_layouts(*t[1:], G), want


def _fastkan_split(xb, layer, G, terms):
    """The tensor-core FastKAN forward in torch: the f32 [SiLU(x) |
    B(LN(x))] as `terms` bf16 terms, each multiplied with the bf16 [Wb; W]
    in f32, the products summed in f32, the f32 bias added, the output
    rounded to bf16 once."""
    lng, lnb, w, wb, bb = layer
    x32 = xb.float()
    xhat, _ = fk.layer_norm_f32(x32)
    basis, _ = fk.wide_basis(xhat * lng.float() + lnb.float(),
                             torch.from_numpy(fk.centers(-2.0, 2.0, G)),
                             fk.inv_h(-2.0, 2.0, G))
    a = torch.cat([x32 * torch.sigmoid(x32), basis], 1)
    wt = torch.cat([wb, w]).float()
    out = sum(t @ wt for t in _terms(a, terms))
    return (out + bb.float()).to(torch.bfloat16)


@pytest.mark.parametrize("shape", [(128, 64, 64, 4), (128, 500, 40, 32)],
                         ids=["D64-O64-G4", "D500-O40-G32"])
def test_fastkan_term_split_matches_jax(rng, shape):
    """The FastKAN forward's split (`fastkan_common.cuh::kFwdTerms`: two
    terms up to 8 centers, three past) against the JAX kernel: within the
    4-ulp bar at the main path's width (4 centers) and at 32 centers over
    500 features (16,500 terms a sum). Fewer terms read further from JAX:
    each term fewer flips the final rounding of more elements, and one term
    (the basis rounded to bf16, as a plain bf16 mma would take it) has a mean
    error more than twice the split's (the split's error is about the
    output's own rounding; one term adds 2^-9 of each product)."""
    n, d, o, G = shape
    terms = 3 if G > 8 else 2
    xb, layer, want = _fastkan_case(rng, n, d, o, G)
    errs = [_errors(_fastkan_split(xb, layer, G, k), want) for k in range(terms, 0, -1)]
    s_max, s_mean, _ = errs[0]
    assert s_max <= 4 * BF16_ULP, s_max
    shares = [share for _, _, share in errs]
    assert shares == sorted(set(shares)), shares  # fewer terms, more elements off
    assert 2 * s_mean < errs[-1][1], (s_mean, errs[-1][1])
    # the plain version (the card's reference) is the f32 product itself
    plain = fk.fastkan_layer_fwd_plain(xb, *layer, -2.0, 2.0)
    assert _errors(_fastkan_split(xb, layer, G, terms), plain)[0] <= 4 * BF16_ULP


def test_bspline_bf16_basis_is_the_plain_rounding(rng):
    """The B-spline forward's tensor-core operand is the bf16 basis tile
    [SiLU(x) | B_0 .. B_NB-1] (kan_common.cuh `basis_tile_bf16`, shared
    with the dW kernel, whose plain operand is `dw_operand`): its f32
    product with [Wb; Ws], rounded once, is the plain version the card is
    checked against, and both meet the JAX kernel within the 4-ulp bar. The
    same product of the unrounded f32 basis differs from JAX on more
    elements: the rounding is the JAX kernel's."""
    n, d, o, k = 150, 24, 40, 3
    grid = np.asarray(jbs.make_grid(d, 4, k))
    wb = (rng.normal(size=(d, o)) * 0.3).astype(np.float32)
    ws = (rng.normal(size=(4 + k, d, o)) * 0.3).astype(np.float32)
    x = rng.normal(size=(n, d)).astype(np.float32)
    want = bspline_kan_matmul(*[jnp.asarray(a, jnp.bfloat16)
                                for a in (x, grid.T.copy(), wb, ws)], k, True)
    t = [torch.from_numpy(a).to(torch.bfloat16)
         for a in (x, grid.T.copy(), wb, ws.reshape(-1, o))]
    w_all = torch.cat([t[2], t[3]]).float()
    tile = (bf.dw_operand(t[0], t[1], k).float() @ w_all).to(torch.bfloat16)
    plain = bf.kan_linear_fwd_plain(*t, k)
    assert _errors(tile, plain)[0] <= 4 * BF16_ULP
    assert _errors(tile, want)[0] <= 4 * BF16_ULP
    assert _errors(plain, want)[0] <= 4 * BF16_ULP
    x32 = t[0].float()
    bases, _ = bf.basis_ladder(x32, t[1].float(), k)
    unrounded = (torch.cat([x32 * torch.sigmoid(x32)] + bases, 1) @ w_all
                 ).to(torch.bfloat16)
    assert _errors(tile, want)[2] < _errors(unrounded, want)[2]
