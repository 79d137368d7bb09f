"""The port's narrow segment sum (`kernels/spmm.py::sorted_segment_sum_narrow`)
against the JAX `pallas/spmm.py::sorted_segment_sum_narrow` in interpret
mode, on the same numpy inputs: k in {1, 4, 8} columns, receivers with
empty rows, a row of 300 edges and edges past the last segment (dropped).

On the CPU the wrapper runs its plain version; tests/test_torch_cuda.py and
chip_smoke.py hold the CUDA kernel against it on the card.

Tolerance: the JAX kernel sums f32 values as bf16 hi/lo pairs through
one-hot products (16 significant bits per value, not exact f32), so the
f32 rtol 1e-4 applies to the output's scale (max |jax|), as for the other
JAX one-hot sums; bf16 values: 4 bf16 ulps of the output's scale."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kagnn_tpu.pallas.spmm import sorted_segment_sum_narrow as jax_narrow
from kagnn_tpu_torch.kernels import spmm

torch.set_num_threads(1)

BF16_ULP = 2.0 ** -8
N_SEG = 200


def _receivers(rng, e=900):
    """Ascending int32 receivers over N_SEG segments: random edges, a hub
    row (17) of 300 edges, no edge for rows 190-199 (and others by chance),
    and 5 edges past the last segment."""
    rcv = np.concatenate([rng.integers(0, 190, e), np.full(300, 17),
                          np.full(5, N_SEG + 3)])
    return np.sort(rcv).astype(np.int32)


def _close(got, want, c):
    got = got.float().numpy()
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    tol = c * max(float(np.abs(want).max()), 1e-6)
    err = float(np.abs(got - want).max())
    assert err <= tol, f"max err {err} > {tol}"


@pytest.mark.parametrize("k,dt", [(1, "f32"), (4, "f32"), (8, "f32"), (4, "bf16")])
def test_narrow_matches_jax(rng, k, dt):
    rcv = _receivers(rng)
    vals = (rng.normal(size=(rcv.size, k)) * 10).astype(np.float32)
    jd, td = {"f32": (jnp.float32, torch.float32),
              "bf16": (jnp.bfloat16, torch.bfloat16)}[dt]
    jv = jnp.asarray(vals, jd)
    want = jax_narrow(jv, jnp.asarray(rcv), N_SEG, interpret=True)
    got = spmm.sorted_segment_sum_narrow(
        torch.tensor(np.asarray(jv.astype(jnp.float32))).to(td),
        torch.from_numpy(rcv), N_SEG)
    assert got.shape == (N_SEG, k) and got.dtype == td and want.dtype == jd
    _close(got, want, 1e-4 if dt == "f32" else 4 * BF16_ULP)
    assert not got[190:].any()  # rows with no edge are 0


def test_narrow_row_ptr_is_the_searchsorted_of_the_receivers(rng):
    rcv = _receivers(rng)
    rp = spmm.narrow_row_ptr(torch.from_numpy(rcv), N_SEG)
    assert rp.dtype == torch.int32
    np.testing.assert_array_equal(rp.numpy(),
                                  np.searchsorted(rcv, np.arange(N_SEG + 1)))


def test_narrow_takes_one_to_eight_columns():
    rcv = torch.zeros(4, dtype=torch.int32)
    for k in (0, 9):
        with pytest.raises(ValueError, match="1 <= k <= 8"):
            spmm.sorted_segment_sum_narrow(torch.ones(4, k), rcv, 2)
