"""The port's narrow segment sum (`kernels/spmm.py::sorted_segment_sum_narrow`)
against the JAX `pallas/spmm.py::sorted_segment_sum_narrow` in interpret
mode, on the same numpy inputs: k in {1, 4, 8} columns, receivers with
empty rows, a row of 300 edges and edges past the last segment (dropped).

On the CPU the wrapper runs its plain version; tests/test_torch_cuda.py and
chip_smoke.py hold the CUDA kernel against it on the card. Here a Python
mirror of the kernel's schedule (`csrc/spmm_narrow.cu`: the row pointer a
thread an edge, light rows whole, heavy rows' pieces at 64-edge chunks in
two slots a chunk, combined in chunk order) is held against
`torch.searchsorted` exactly and against the plain version, on receivers
with empty rows, receivers past the last segment or below 0, no edge at
all, and hub rows that start at a chunk's head, inside a chunk and after
dropped edges.

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
from kagnn_tpu_torch.kernels.selfcheck import narrow_cases, narrow_f64

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


def _row_ptr_rule(rcv, n):
    """csrc/spmm_narrow.cu narrow_row_ptr_kernel, thread by thread: thread
    t (0 <= t <= E) writes row_ptr[r] = t for r in (rcv[t-1], rcv[t]],
    rcv[-1] = -1 and rcv[E] = n standing for the ends (a run of more than
    8 rows is written by the thread's block, with the same values). Each row
    must be written exactly once."""
    e = len(rcv)
    rp = np.full(n + 1, -1, np.int64)
    for t in range(e + 1):
        prev = -1 if t == 0 else int(rcv[t - 1])
        if prev >= n:
            continue
        cur = n if t == e else min(int(rcv[t]), n)
        for r in range(max(prev + 1, 0), cur + 1):
            assert rp[r] == -1, f"row {r} written twice"
            rp[r] = t
    assert (rp >= 0).all(), "a row no thread wrote"
    return rp


def _split_sum(vals, rcv, n, piece=spmm.NARROW_PIECE):
    """narrow_sum_kernel and narrow_combine_kernel in Python: the light rows
    whole, each chunk's two slots (slot 0 the row of its first edge unless
    that receiver is negative, slot 1 the row of its last edge when it
    differs) for heavy rows, then each heavy row's pieces from the chunk of
    its first edge to the one it ends in. Every row is written exactly
    once."""
    rp = _row_ptr_rule(rcv, n)
    e, k = vals.shape
    end = rp[n]
    chunks = -(-e // piece)
    partial = np.full((2 * chunks, k), np.nan)
    first_row = np.full(chunks, -(2 ** 31))
    out = np.full((n, k), np.nan)
    for ch in range(chunks):
        cs, ce = ch * piece, min(ch * piece + piece, end)
        if cs >= end:
            continue
        first, last = int(rcv[cs]), int(rcv[ce - 1])
        first_row[ch] = first
        for slot, row in ((0, first), (1, last)):
            if row < 0 or (slot == 1 and last == first):
                continue
            e0, e1 = min(rp[row], end), min(rp[row + 1], end)
            if e1 - e0 > piece:
                partial[2 * ch + slot] = vals[max(e0, cs):min(e1, ce)].sum(0)
    for row in range(n):
        if rp[row + 1] - rp[row] <= piece:
            out[row] = vals[rp[row]:rp[row + 1]].sum(0)
    for ch in range(chunks):
        cs = ch * piece
        if cs >= end or first_row[ch] < 0:
            continue
        row = first_row[ch]
        e0, e1 = min(rp[row], end), min(rp[row + 1], end)
        if not (e1 - e0 > piece and e1 <= cs + piece):
            continue
        head = 1 if e0 % piece else 0
        slots = [2 * c + (head if c == e0 // piece else 0)
                 for c in range(e0 // piece, ch + 1)]
        assert not np.isnan(partial[slots]).any(), "a piece no warp wrote"
        assert np.isnan(out[row]).all(), f"row {row} written twice"
        out[row] = partial[slots].sum(0)
    assert not np.isnan(out).any(), "a row nobody wrote"
    return rp, out


# the receivers the card checks use too (kernels/selfcheck.py)
NARROW_CASES = narrow_cases("cpu")


@pytest.mark.parametrize("case", list(NARROW_CASES))
def test_narrow_row_ptr_rule_is_searchsorted(case):
    rcv, n = NARROW_CASES[case]
    want = spmm.narrow_row_ptr(rcv, n).numpy()
    rcv = rcv.numpy()
    np.testing.assert_array_equal(_row_ptr_rule(rcv, n), want)
    np.testing.assert_array_equal(want, np.searchsorted(rcv, np.arange(n + 1)))


def _sum_f64(vals, rcv, n):
    """The segment sums in f64 of the edges whose receiver is in [0, n)."""
    return narrow_f64(torch.from_numpy(vals), torch.from_numpy(rcv), n).numpy()


@pytest.mark.parametrize("case", list(NARROW_CASES))
def test_narrow_split_schedule_sums_every_edge_once(rng, case):
    """The mirror of the split against the sums in f64 (the order of the
    pieces is the only difference)."""
    rcv, n = NARROW_CASES[case]
    rcv = rcv.numpy()
    vals = rng.normal(size=(rcv.size, 3))
    _, got = _split_sum(vals, rcv, n)
    np.testing.assert_allclose(got, _sum_f64(vals, rcv, n), rtol=1e-12, atol=1e-12)
