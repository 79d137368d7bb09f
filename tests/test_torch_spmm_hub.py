"""The segment sum (`kernels/spmm.py`) on CSR rows far longer than the rest,
on the CPU.

The graph (`_hub_graph`): node 0 receives 2,500 edges, nodes 1-3 receive
63, 64 and 65 (one short of spmm's 64-edge piece, one piece, one past it),
node 4 sends 300 (a heavy row of the sender CSR), light edges over nodes
5-199, isolated nodes, and padding to a multiple of 1,024 edges, which the
pad row holds in both CSRs (heavy by its padding: spmm has no edge mask).

On it, over the receiver CSR with idx = senders (the gin/fastkan step's sum
of z), over the sender CSR with idx = receivers_by_sender (A^T dz) and over
the receiver CSR without idx (receiver-sorted messages), in f32 and bf16 at
D 64 and 128:
  * the plain version (`sorted_segment_sum_plain`, what the wrapper runs on
    a CPU tensor) against the JAX `sorted_segment_sum` in interpret mode, as
    the JAX package's tests run it (tests/test_pallas_spmm.py), on the
    gathered (E, D) messages over the receivers (or senders_sorted);
  * the split that the CUDA kernel makes (csrc/spmm.cu with kan_common.cuh's
    piece schedule), computed in torch step by step: a row of at most 64
    edges summed whole in edge order; a heavier row cut at the 64-edge
    chunks of the edge array, each piece summed by 4 lane groups taking
    every 4th edge and met in the kernel's butterfly, then the pieces added
    in chunk order; every edge of a heavy row in exactly one piece and
    every heavy row combined once (`test_split_schedule_covers_every_edge`).
    It meets the JAX kernel within the same bars as the plain version.

Bars (tests/test_torch_kernels.py's for spmm): f32 1e-4 of the output's scale
(max |jax|: the JAX kernel carries f32 messages as bf16 hi/lo pairs), bf16 4
bf16 ulps of the output's scale."""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_kernels import DTYPES, close

from kagnn_tpu.graphs import single_graph as jax_single_graph
from kagnn_tpu.pallas.spmm import sorted_segment_sum as jax_ssum
from kagnn_tpu_torch.graphs import single_graph
from kagnn_tpu_torch.kernels import spmm

torch.set_num_threads(1)

PIECE = spmm.PIECE
GROUPS = 4  # lane groups of a chunk warp at 16-byte loads (csrc/spmm.cu Cfg::R)
ROWS = ((0, 2500), (1, PIECE - 1), (2, PIECE), (3, PIECE + 1))
SENDS = (4, 300)
CSRS = ("receiver", "sender", "receiver-no-idx")


@functools.cache
def _hub_graph(n=220, light=1000, isolated=20):
    """(JAX graph, port graph) of the module docstring's graph."""
    rng = np.random.default_rng(17)
    rcv = np.concatenate([np.full(d, r) for r, d in ROWS]
                         + [rng.integers(5, n - isolated, light + SENDS[1])])
    snd = np.concatenate([rng.integers(0, n - isolated, rcv.size - SENDS[1]),
                          np.full(SENDS[1], SENDS[0])])
    kw = dict(n_node=n, edge_pad_multiple=1024)
    return jax_single_graph(snd, rcv, **kw), single_graph(snd, rcv, device="cpu", **kw)


def _csr(kind, gt):
    """(row_ptr, idx or None) of one CSR of the port graph."""
    if kind == "sender":
        return gt.send_row_ptr, gt.receivers_by_sender
    return gt.recv_row_ptr, None if kind == "receiver-no-idx" else gt.senders


def _jax_sum(kind, gj, table, jd):
    """The JAX segment sum in interpret mode over the gathered messages."""
    t = jnp.asarray(table, jd)
    if kind == "receiver":
        return jax_ssum(jnp.take(t, gj.senders, axis=0), gj.receivers, gj.n_node_pad, True)
    if kind == "sender":
        return jax_ssum(jnp.take(t, gj.receivers_by_sender, axis=0), gj.senders_sorted,
                        gj.n_node_pad, True)
    return jax_ssum(t, gj.receivers, gj.n_node_pad, True)


def _row_of(row_ptr, e):
    """The row of edge e: the last r with row_ptr[r] <= e (kan::row_of_edge)."""
    return int(np.searchsorted(row_ptr, e, side="right")) - 1


def _schedule(row_ptr):
    """The kernel's piece schedule over all edges: (slots, combines) with
    slots[(chunk, slot)] = (row, lo, hi), a heavy row's piece inside a chunk,
    and combines[row] = the slot keys of its pieces in chunk order, from the
    chunk holding its last edge (kan::chunk_piece, ends_heavy, piece_slots)."""
    rp = row_ptr.numpy().astype(np.int64)
    end = int(rp[-1])
    slots, combines = {}, {}
    for ch in range(-(-end // PIECE)):
        cs, ce = ch * PIECE, min(ch * PIECE + PIECE, end)
        first, last = _row_of(rp, cs), _row_of(rp, ce - 1)
        for slot, row in ((0, first), (1, last)):
            if slot == 1 and last == first:
                continue
            e0, e1 = rp[row], rp[row + 1]
            if e1 - e0 > PIECE:
                slots[(ch, slot)] = (row, max(e0, cs), min(e1, ce))
        e0, e1 = rp[first], rp[first + 1]
        if e1 - e0 > PIECE and e1 <= cs + PIECE:  # ends_heavy
            head = 1 if e0 % PIECE else 0
            combines[first] = [(k, head if k == e0 // PIECE else 0)
                               for k in range(e0 // PIECE, ch + 1)]
    return slots, combines


def _piece_sum(src, lo, hi):
    """A chunk warp's sum of rows lo..hi-1 of src (f32): lane group q sums
    edges lo+q, lo+q+4, .. in order; the groups meet in the kernel's
    butterfly, (s0 + s1) + (s2 + s3)."""
    zero = torch.zeros(src.shape[1])
    s = [functools.reduce(lambda a, e: a + src[e], range(lo + q, hi, GROUPS), zero)
         for q in range(GROUPS)]
    return (s[0] + s[1]) + (s[2] + s[3])


def _split_sum(msgs, row_ptr, idx):
    """The CUDA kernel's split in torch: light rows whole in edge order,
    heavy rows as pieces combined in chunk order, f32 sums, one cast."""
    return _split_sum32(msgs, row_ptr, idx).to(msgs.dtype)


def _split_sum32(msgs, row_ptr, idx):
    """_split_sum before its cast: the f32 sums (kan_common.cuh's split row
    sum, which gin_fused.cu shares)."""
    src = (msgs if idx is None else msgs.index_select(0, idx.long())).float()
    rp = row_ptr.numpy().astype(np.int64)
    n = rp.size - 1
    out = torch.zeros(n, msgs.shape[1])
    for row in range(n):
        e0, e1 = rp[row], rp[row + 1]
        if e1 - e0 <= PIECE:
            out[row] = functools.reduce(lambda a, e: a + src[e], range(e0, e1),
                                        torch.zeros(msgs.shape[1]))
    slots, combines = _schedule(row_ptr)
    part = {key: _piece_sum(src, lo, hi) for key, (_, lo, hi) in slots.items()}
    for row, keys in combines.items():
        out[row] = functools.reduce(lambda a, k: a + part[k], keys,
                                    torch.zeros(msgs.shape[1]))
    return out


@pytest.mark.parametrize("kind", CSRS)
def test_split_schedule_covers_every_edge(kind):
    """Every edge of a row of more than 64 edges lies in exactly one piece of
    that row, and every such row is combined exactly once; node 0 (or node 4
    in the sender CSR) and the pad row are heavy."""
    gj, gt = _hub_graph()
    row_ptr, _ = _csr(kind, gt)
    rp = row_ptr.numpy().astype(np.int64)
    deg = np.diff(rp)
    heavy = set(np.nonzero(deg > PIECE)[0].tolist())
    assert gt.n_node_pad - 1 in heavy and (4 if kind == "sender" else 0) in heavy
    slots, combines = _schedule(row_ptr)
    assert set(combines) == heavy
    for row in heavy:
        pieces = [slots[k] for k in combines[row]]
        assert all(r == row for r, _, _ in pieces)
        covered = np.concatenate([np.arange(lo, hi) for _, lo, hi in pieces])
        np.testing.assert_array_equal(covered, np.arange(rp[row], rp[row + 1]))


@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("kind", CSRS)
@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_plain_and_split_match_jax(dt, kind, D):
    """The plain version and the split, on the same inputs, against the JAX
    kernel; the split against the plain version within the same bar."""
    jd, td = DTYPES[dt]
    gj, gt = _hub_graph()
    rows = gt.n_edge_pad if kind == "receiver-no-idx" else gt.n_node_pad
    table = np.random.default_rng(D).normal(size=(rows, D)).astype(np.float32)
    want = _jax_sum(kind, gj, table, jd)
    msgs = torch.from_numpy(table).to(td)
    row_ptr, idx = _csr(kind, gt)
    plain = spmm.sorted_segment_sum(msgs, row_ptr, idx)
    split = _split_sum(msgs, row_ptr, idx)
    assert plain.dtype == split.dtype == td
    close(plain, want, dt, scaled=True, err_msg="plain")
    close(split, want, dt, scaled=True, err_msg="split")
    close(split, plain, dt, scaled=True, err_msg="split vs plain")
