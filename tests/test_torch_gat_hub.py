"""The GAT kernels on a receiver row far longer than the rest, on the CPU.

The graph (`_hub_graph`): node 0 receives 2,500 valid edges, three of the
JAX forward's 1,024-edge chunks, so its online softmax raises the rounded
shift part-way through the row; rows of 63, 64 and 65 edges; a heavy row of
300 that starts inside a chunk the 65-edge row ends in (two heavy rows in
one chunk); light rows, isolated nodes, and padding to a multiple of 1,024
edges held by the pad row.

On it, the plain versions of `gat_fwd`, `gat_dadst` and `gat_sender`
(kernels/gat_fused.py, kernels/gat_bwd.py) against `_gat_fwd_parts`,
`gat_bwd_dadst` and `gat_bwd_sender` in interpret mode. Then the split of
heavy rows that the CUDA kernels make (csrc/gat_fused.cu, csrc/gat_bwd.cu,
csrc/kan_common.cuh's piece schedule) in two steps: the schedule itself,
lane by lane where a warp searches, must give every valid edge of a heavy
row exactly one piece slot and every heavy row exactly one combine; and the
forward and dadst computed piece by piece on that schedule (each piece's
max, the row's one rounded shift, the sums per piece, the self term first
and the pieces in chunk order) must match the JAX kernels within the same
bars as the plain versions: the split keeps the JAX rounding points.

Bars (test_torch_gat.py's): f32 1e-4 of the output's scale (1e-3 for the
backward's sums), bf16 4 bf16 ulps of the output's scale."""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_gat import DTYPES, SLOPE, _attention_inputs, _np32, close

from kagnn_tpu.graphs import single_graph as jax_single_graph
from kagnn_tpu.pallas.gat_bwd import gat_bwd_dadst, gat_bwd_sender
from kagnn_tpu.pallas.gat_fused import CHUNK, IMAX, _gat_fwd_parts
from kagnn_tpu_torch.graphs import single_graph
from kagnn_tpu_torch.kernels import gat_bwd as gbw
from kagnn_tpu_torch.kernels import gat_fused as gfu
from kagnn_tpu_torch.kernels._common import GAT_PIECE, leaky

torch.set_num_threads(1)

HEADS, C = 2, 16
HUB = 2500
# (receiver, in-degree) of the rows placed around the piece size
ROWS = ((0, HUB), (1, GAT_PIECE - 1), (2, GAT_PIECE), (3, GAT_PIECE + 1),
        (4, 300))


def _hub_graph(n=220, light=1000, isolated=20):
    """(JAX graph, port graph) of the module docstring's graph."""
    rng = np.random.default_rng(11)
    rcv = np.concatenate([np.full(d, r) for r, d in ROWS]
                         + [rng.integers(len(ROWS), n - isolated, light)])
    snd = rng.integers(0, n, rcv.size)
    kw = dict(n_node=n, edge_pad_multiple=1024)
    return jax_single_graph(snd, rcv, **kw), single_graph(snd, rcv, device="cpu", **kw)


@functools.cache
def _case(dt):
    """The graphs, the inputs and the JAX kernels' outputs in dtype dt:
    h, asrc, adst, dout as float32 numpy; out, alpha, S, dadst, dh, dasrc
    from the JAX kernels."""
    jd, _ = DTYPES[dt]
    gj, gt = _hub_graph()
    assert gt.n_edge > 3 * CHUNK // 2 and (gt.n_edge_pad - gt.n_edge) > 0
    rng = np.random.default_rng(12)
    n, hc = gt.n_node_pad, HEADS * C
    h, amat, asrc, adst = _attention_inputs(rng, n, HEADS, C, jd)
    # logits spread over about 230 in the hub row (exactly scaled: a power
    # of two), so a weight formed with any shift but the row's overflows
    # or vanishes
    amat, asrc = amat * 32, asrc * 32
    dout = _np32(jnp.asarray(rng.normal(size=(n, hc)), jd))
    hj, dj = jnp.asarray(h, jd), jnp.asarray(dout, jd)
    out, (msgs, alpha) = _gat_fwd_parts(
        hj, jnp.asarray(asrc), jnp.asarray(adst), jnp.asarray(amat),
        gj.senders, gj.receivers, gj.edge_mask, HEADS, SLOPE, True)
    s = jnp.sum((dj * out).astype(jnp.float32).reshape(n, HEADS, C), axis=2)
    recv_m = jnp.where(gj.edge_mask, gj.receivers, IMAX)
    dadst = gat_bwd_dadst(msgs, recv_m, dj, jnp.asarray(adst), alpha, s,
                          jnp.asarray(amat), HEADS, hc, SLOPE, interpret=True)

    def hilo(x):
        hi = x.astype(jnp.bfloat16)
        lo = (x - hi.astype(jnp.float32)).astype(jnp.bfloat16)
        return hi.astype(jd), lo.astype(jd)

    nrw = jnp.concatenate([*hilo(jnp.asarray(adst)), *hilo(alpha), *hilo(s)],
                          axis=1)
    rbs = gj.receivers_by_sender
    snd_m = jnp.where(gj.edge_mask_by_sender, gj.senders_sorted, IMAX)
    dh, dasrc = gat_bwd_sender(
        (jnp.take(dj, rbs, axis=0),), jnp.take(nrw, rbs, axis=0), snd_m, hj,
        jnp.asarray(amat), HEADS, hc, SLOPE, interpret=True, part_widths=(hc,))
    jax_out = {k: _np32(v) for k, v in dict(
        out=out, alpha=alpha, s=s, dadst=dadst, dh=dh, dasrc=dasrc).items()}
    return gt, dict(h=h, asrc=asrc, adst=adst, dout=dout), jax_out


def _torch_inputs(dt, x):
    _, td = DTYPES[dt]
    return (torch.from_numpy(x["h"]).to(td), torch.from_numpy(x["asrc"]),
            torch.from_numpy(x["adst"]), torch.from_numpy(x["dout"]).to(td))


@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_gat_kernels_plain_match_jax_on_a_hub_row(dt):
    """out and alpha of the plain forward, dadst, dh and dasrc of the plain
    backward versions against the JAX kernels in interpret mode."""
    g, x, want = _case(dt)
    h, asrc, adst, dout = _torch_inputs(dt, x)
    out, alpha = gfu.gat_fwd(h, asrc, adst, g.senders, g.recv_row_ptr,
                             g.n_edge, SLOPE)
    close(out, want["out"], dt, err_msg="out", scaled=True)
    close(alpha, want["alpha"], "f32", err_msg="alpha", scaled=True)
    a, s = (torch.from_numpy(want[k]) for k in ("alpha", "s"))
    dadst = gbw.gat_dadst(h, asrc, adst, a, s, dout, g.senders, g.recv_row_ptr,
                          g.n_edge, SLOPE)
    dh, dasrc = gbw.gat_sender(h, asrc, adst, a, s, dout, g.receivers_by_sender,
                               g.send_row_ptr, g.n_edge, SLOPE)
    for name, got in (("dadst", dadst), ("dh", dh), ("dasrc", dasrc)):
        close(got, want[name], "f32", grad=True, err_msg=name, scaled=True)


# --- the split, as the CUDA kernels schedule it -----------------------------


def _row_of_edge(row_ptr, n, e):
    """csrc/gat_common.cuh row_of_edge, lane by lane: each round the 32
    lanes probe 32 points of [lo, hi) and the last lane at or below e
    narrows it."""
    lo, hi = 0, n
    while hi - lo > 1:
        step = (hi - lo + 31) // 32
        ok = [q < hi and row_ptr[q] <= e for q in (lo + lane * step for lane in range(32))]
        assert ok[0]
        lo += max(i for i, b in enumerate(ok) if b) * step
        hi = min(hi, lo + step)
    return lo


def _clipped(row_ptr, row, end):
    return min(row_ptr[row], end), min(row_ptr[row + 1], end)


def _piece_slot(k, e0, piece=GAT_PIECE):
    """csrc/kan_common.cuh piece_slots(e0)(k)."""
    return 2 * k + (1 if k == e0 // piece and e0 % piece else 0)


def _schedule(row_ptr, n_edge, piece=GAT_PIECE):
    """csrc/kan_common.cuh's piece schedule over the valid edges, chunk by
    chunk as the chunk warps run it: ({slot: (row, lo, hi)} of the pieces
    summed, {chunk: row} of the combines)."""
    n = len(row_ptr) - 1
    pieces, combines = {}, {}
    for ch in range(-(-n_edge // piece)):
        cs, ce = ch * piece, min(ch * piece + piece, n_edge)
        first, last = _row_of_edge(row_ptr, n, cs), _row_of_edge(row_ptr, n, ce - 1)
        for slot, row in enumerate((first, last)):
            if slot == 1 and row == first:
                break
            e0, e1 = _clipped(row_ptr, row, n_edge)
            if e1 - e0 > piece:
                assert 2 * ch + slot not in pieces
                pieces[2 * ch + slot] = (row, max(e0, cs), min(e1, ce))
        e0, e1 = _clipped(row_ptr, first, n_edge)
        if e1 - e0 > piece and e1 <= cs + piece:
            combines[ch] = first
    return pieces, combines


def _split_edges(g, n_edge):
    """Per valid edge the piece it is summed in: its slot for a heavy row,
    -1 - row for a light row (summed whole by its row's warp); and per row
    its pieces in the combine's order (chunk order), or None."""
    rp = g.recv_row_ptr.tolist()
    pieces, combines = _schedule(rp, n_edge)
    of_edge = np.full(n_edge, 0, np.int64)
    for r in range(len(rp) - 1):
        e0, e1 = _clipped(rp, r, n_edge)
        of_edge[e0:e1] = -1 - r
    for slot, (_, lo, hi) in pieces.items():
        of_edge[lo:hi] = slot
    walks = {}
    for ch, row in combines.items():
        e0, _ = _clipped(rp, row, n_edge)
        walks[row] = [_piece_slot(k, e0) for k in range(e0 // GAT_PIECE, ch + 1)]
    return pieces, of_edge, walks


@pytest.mark.parametrize("cut", [0, 1100])
def test_split_schedule_gives_each_heavy_row_its_pieces(cut):
    """The schedule on the hub graph, and with n_edge cut 1,100 edges short
    (row 4, heavy, then runs past n_edge): the warp search finds each
    chunk's rows; every valid edge of a heavy row (more than GAT_PIECE valid
    edges) lies in exactly one piece slot of its own row; each heavy row is
    combined once, walking exactly its slots in chunk order; light rows,
    the pad row with its padded edges among them, are not split."""
    _, g = _hub_graph()
    n_edge = g.n_edge - cut
    rp = g.recv_row_ptr.tolist()
    rows_of = np.repeat(np.arange(len(rp) - 1), np.diff(rp))
    for e in list(range(0, n_edge, GAT_PIECE)) + [n_edge - 1]:
        assert _row_of_edge(rp, len(rp) - 1, e) == rows_of[e]
    pieces, of_edge, walks = _split_edges(g, n_edge)
    deg = np.array([np.subtract(*_clipped(rp, r, n_edge)[::-1]) for r in range(len(rp) - 1)])
    heavy = set(np.nonzero(deg > GAT_PIECE)[0].tolist())
    assert heavy == set(walks) and {0, 3, 4} <= heavy and not {1, 2} & heavy
    assert len(rp) - 2 not in heavy  # the pad row: 1,024-edge padding, light
    slots = {s for s, (row, _, _) in pieces.items()}
    assert sorted(s for w in walks.values() for s in w) == sorted(slots)
    for row, walk in walks.items():
        assert walk == sorted(walk) and all(pieces[s][0] == row for s in walk)
        e0, e1 = _clipped(rp, row, n_edge)
        assert sum(pieces[s][2] - pieces[s][1] for s in walk) == e1 - e0
        assert (of_edge[e0:e1] >= 0).all()
    shared = [ch for ch in range(-(-n_edge // GAT_PIECE))
              if 2 * ch in pieces and 2 * ch + 1 in pieces]
    assert shared  # two heavy rows' pieces in one chunk (rows 3 and 4)


def _split_forward(h, asrc, adst, g, n_edge):
    """csrc/gat_fused.cu's forward in torch on the schedule: light rows
    whole; a heavy row's pieces give their max of the gathered asrc, the
    row's shift is rounded once from the max of those, each piece sums its
    weights (rounded to h's dtype in the numerator) with that shift, and
    the combine adds the self term, then the pieces in chunk order."""
    n, hc = h.shape
    heads = asrc.shape[1]
    c = hc // heads
    pieces, of_edge, walks = _split_edges(g, n_edge)
    rcv = torch.repeat_interleave(torch.arange(n), torch.diff(g.recv_row_ptr).long())[:n_edge]
    snd = g.senders[:n_edge].long()
    grp = torch.from_numpy(of_edge)
    light = grp < 0
    lg_src = asrc[snd]
    sl = leaky(asrc + adst, SLOPE)
    # the row max: light rows over their edges, heavy rows over their pieces
    def amax(rows, index, src):
        return torch.full((rows, heads), -torch.inf).scatter_reduce_(
            0, index[:, None].expand(-1, heads), src, "amax")

    n_slots = 2 * (-(-n_edge // GAT_PIECE))
    ma = amax(n, rcv[light], lg_src[light])
    pmax = amax(n_slots, grp[~light], lg_src[~light])
    for row, walk in walks.items():
        ma[row] = pmax[walk].amax(0)
    has = torch.diff(g.recv_row_ptr.clamp(max=n_edge)) > 0
    m = torch.where(has[:, None], torch.maximum(sl, leaky(ma + adst, SLOPE)), sl)
    m = m.to(torch.bfloat16).float()
    w = torch.exp(leaky(lg_src + adst[rcv], SLOPE) - m[rcv])
    wh = w.to(h.dtype).float().repeat_interleave(c, 1) * h[snd].float()
    es = torch.exp(sl - m)
    den = es.clone()
    acc = es.repeat_interleave(c, 1) * h.float()
    den.index_add_(0, rcv[light], w[light])
    acc.index_add_(0, rcv[light], wh[light])
    pden = torch.zeros(n_slots, heads).index_add_(0, grp[~light], w[~light])
    pacc = torch.zeros(n_slots, hc).index_add_(0, grp[~light], wh[~light])
    for row, walk in walks.items():
        for slot in walk:
            den[row] += pden[slot]
            acc[row] += pacc[slot]
    return (acc / den.repeat_interleave(c, 1)).to(h.dtype), m + torch.log(den)


def _split_dadst(h, asrc, adst, alpha, s, dout, g, n_edge):
    """csrc/gat_bwd.cu's gat_dadst in torch on the schedule: light rows
    whole, a heavy row's pieces summed apart and added in chunk order."""
    n = h.shape[0]
    heads = asrc.shape[1]
    _, of_edge, walks = _split_edges(g, n_edge)
    rcv = torch.repeat_interleave(torch.arange(n), torch.diff(g.recv_row_ptr).long())[:n_edge]
    snd = g.senders[:n_edge].long()
    _, dz = gbw._edge_terms(h, asrc, adst, alpha, s, dout, snd, rcv, SLOPE)
    grp = torch.from_numpy(of_edge)
    light = grp < 0
    out = torch.zeros(n, heads).index_add_(0, rcv[light], dz[light])
    part = torch.zeros(2 * (-(-n_edge // GAT_PIECE)), heads)
    part.index_add_(0, grp[~light], dz[~light])
    for row, walk in walks.items():
        out[row] = sum((part[slot] for slot in walk), torch.zeros(heads))
    return out


@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_split_rows_keep_the_jax_rounding_points(dt):
    """The forward (out, alpha) and dadst computed piece by piece on the
    schedule against the JAX kernels within the plain versions' bars, and
    against the plain versions themselves (equal shifts: the same alpha to
    f32 rounding)."""
    g, x, want = _case(dt)
    h, asrc, adst, dout = _torch_inputs(dt, x)
    out, alpha = _split_forward(h, asrc, adst, g, g.n_edge)
    assert out.dtype == h.dtype
    close(out, want["out"], dt, err_msg="split out", scaled=True)
    close(alpha, want["alpha"], "f32", err_msg="split alpha", scaled=True)
    p_out, p_alpha = gfu.gat_fwd_plain(h, asrc, adst, g.senders, g.recv_row_ptr,
                                       g.n_edge, SLOPE)
    close(out, p_out, dt, err_msg="split out vs plain", scaled=True)
    close(alpha, p_alpha, "f32", err_msg="split alpha vs plain")
    a, s = (torch.from_numpy(want[k]) for k in ("alpha", "s"))
    dadst = _split_dadst(h, asrc, adst, a, s, dout, g, g.n_edge)
    close(dadst, want["dadst"], "f32", grad=True, err_msg="split dadst", scaled=True)
