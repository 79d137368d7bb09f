"""The halo-exchange node partition, the counterpart of
`kagnn_tpu/dist/halo.py`: full-graph node classification with the nodes
sharded over the ranks of a process group.

  * nodes are sharded into contiguous blocks of B rows: rank d owns global
    rows [d*B, (d+1)*B);
  * edges are partitioned by destination block, so every edge of a
    receiver lives on the receiver's owner: segment sums, GAT's edge
    softmax and the GCN in-degree are local;
  * the only traffic is one `all_to_all_single` of the boundary sender rows
    per aggregation (ops/segment.py `halo_exchange`: D*H rows a rank, not
    N), plus all-reduces of the BatchNorm and loss statistics;
  * the edge list is pre-split into internal edges (sender local) and halo
    edges (sender remote), so the internal segment sum needs nothing of the
    exchange.

`build_halo_plan` and `HaloPlan` are the JAX package's numpy code, copied
(its module cannot be imported without flax): the same graph gives the same
arrays. `make_halo_node_step` builds one rank's step from the plan: its
slices of the plan on its device, the model run inside
`segment.halo_mode`, the global masked cross entropy, and the gradients
averaged over the ranks before one optimizer step on every rank. Every rank
holds the same weights (the same seed) and so takes the same update.

The gradient's scale: every rank's loss is the global one, and an
all-reduce's backward all-reduces the cotangents, so each cotangent that
passes one is the sum of the D ranks' and the summed gradients are D times
the global gradient; averaging them gives it exactly. This is the JAX
step's own arithmetic (`shard_map(check_vma=False)`, psum's transpose a
psum, then `pmean(grads)`).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist

from kagnn_tpu_torch.graphs.batch import GraphBatch, _row_ptr
from kagnn_tpu_torch.ops import segment
from kagnn_tpu_torch.train import losses
from kagnn_tpu_torch.train.loops import make_node_steps


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


@dataclasses.dataclass(frozen=True)
class HaloPlan:
    """Host-built partition plan. Every per-rank array is stacked along a
    leading axis of size `n_shards`; rank d takes slice d."""

    n_shards: int
    block: int        # B: node rows per shard
    halo: int         # H: max boundary rows exchanged per (owner, dest) pair
    e_loc: int        # padded edges per shard
    boundary_rows: int  # true number of (owner, dest, node) boundary entries
    # --- per-shard edge topology (ext sender space: [0, B + D*H)) ---
    senders: np.ndarray      # (D, E_loc) int32
    receivers: np.ndarray    # (D, E_loc) int32, local [0, B), ascending
    edge_mask: np.ndarray    # (D, E_loc) bool
    n_edge: np.ndarray       # (D,) int32 valid edges per shard
    # --- halo exchange plan ---
    send_idx: np.ndarray     # (D, D, H) int32: rows of shard d to send to p
    send_mask: np.ndarray    # (D, D, H) bool
    dinv_ext: np.ndarray     # (D, B + D*H) f32: (deg+1)^-1/2, ext space
    # --- node shard ---
    node_mask: np.ndarray    # (D, B) bool
    n_node: np.ndarray       # (D,) int32
    # --- optional internal/halo edge split ---
    s_int: Optional[np.ndarray] = None    # (D, Ei) int32 local sender rows
    r_int: Optional[np.ndarray] = None    # (D, Ei) int32
    int_sel: Optional[np.ndarray] = None  # (D, Ei) int32 into full edge list
    int_mask: Optional[np.ndarray] = None  # (D, Ei) bool
    s_halo: Optional[np.ndarray] = None   # (D, Eh) int32 rows into recv_flat
    r_halo: Optional[np.ndarray] = None   # (D, Eh) int32
    halo_sel: Optional[np.ndarray] = None  # (D, Eh) int32
    halo_mask: Optional[np.ndarray] = None  # (D, Eh) bool
    # --- per-shard sender sort (ext space) ---
    senders_perm: Optional[np.ndarray] = None    # (D, E_loc) int32
    senders_sorted: Optional[np.ndarray] = None  # (D, E_loc) int32
    receivers_by_sender: Optional[np.ndarray] = None  # (D, E_loc) int32
    edge_mask_by_sender: Optional[np.ndarray] = None  # (D, E_loc) bool

    @property
    def n_total(self) -> int:
        return self.n_shards * self.block

    def comm_rows_per_device(self) -> int:
        """all_to_all rows moved per rank per exchange (padded)."""
        return self.n_shards * self.halo

    def shard_nodes(self, arr: np.ndarray, fill=0) -> np.ndarray:
        """Pad a global per-node array (Np, ...) to (D*B, ...) and reshape to
        the stacked (D, B, ...) node-shard layout."""
        arr = np.asarray(arr)
        pad = self.n_total - arr.shape[0]
        if pad:
            widths = [(0, pad)] + [(0, 0)] * (arr.ndim - 1)
            arr = np.pad(arr, widths, constant_values=fill)
        return arr.reshape((self.n_shards, self.block) + arr.shape[1:])


def build_halo_plan(g: GraphBatch, n_shards: int, *, block_multiple: int = 8,
                    halo_multiple: int = 8, edge_multiple: int = 128,
                    split_edges: bool = True,
                    block: Optional[int] = None) -> HaloPlan:
    """Partition a single (full-batch) graph for halo-exchange training.

    Nodes go to contiguous blocks of B = ceil(Np/D) rows; edges go to the
    owner of their receiver (edges are receiver-sorted, so each shard's edge
    list is a contiguous slice of the global list). For every (dest d,
    owner p) pair the plan records the sorted unique boundary senders
    R(d,p); rank p sends x[R(d,p)] to d in slot d of one all_to_all.
    """
    D = int(n_shards)
    senders = _np(g.senders)
    receivers = _np(g.receivers)
    emask = _np(g.edge_mask)
    np_pad = g.n_node_pad
    if block is not None:
        B = int(block)
        assert B * D >= np_pad, (
            f"block={B} x {D} shards < {np_pad} padded nodes")
    else:
        B = _round_up(-(-np_pad // D), block_multiple)
    ntot = B * D

    s = senders[emask].astype(np.int64)
    r = receivers[emask].astype(np.int64)
    order = np.argsort(r, kind="stable")
    s, r = s[order], r[order]

    bounds = np.searchsorted(r, np.arange(D + 1) * B).astype(np.int64)
    n_edge_dev = np.diff(bounds).astype(np.int32)
    e_loc = _round_up(max(int(n_edge_dev.max(initial=0)), 1), edge_multiple)

    # symmetric-norm degrees (valid in-edges + self loop), data-independent
    deg = np.bincount(r, minlength=ntot).astype(np.float32) + 1.0
    dinv = 1.0 / np.sqrt(deg)

    # boundary sets R(d, p)
    rdp: dict[tuple[int, int], np.ndarray] = {}
    h_max = 0
    boundary_rows = 0
    for d in range(D):
        sd = s[bounds[d]:bounds[d + 1]]
        owner = sd // B
        for p in range(D):
            if p == d:
                continue
            uniq = np.unique(sd[owner == p])
            if uniq.size:
                rdp[(d, p)] = uniq
                h_max = max(h_max, int(uniq.size))
                boundary_rows += int(uniq.size)
    H = _round_up(max(h_max, 1), halo_multiple)

    send_idx = np.zeros((D, D, H), np.int32)
    send_mask = np.zeros((D, D, H), bool)
    for (d, p), uniq in rdp.items():
        send_idx[p, d, :uniq.size] = (uniq - p * B).astype(np.int32)
        send_mask[p, d, :uniq.size] = True

    ext_senders = np.zeros((D, e_loc), np.int32)
    loc_receivers = np.full((D, e_loc), B - 1, np.int32)
    edge_mask = np.zeros((D, e_loc), bool)
    dinv_ext = np.zeros((D, B + D * H), np.float32)
    is_internal = np.zeros((D, e_loc), bool)
    for d in range(D):
        sd = s[bounds[d]:bounds[d + 1]]
        rd = r[bounds[d]:bounds[d + 1]]
        ne = sd.size
        owner = sd // B
        ext = np.empty(ne, np.int64)
        local = owner == d
        ext[local] = sd[local] - d * B
        for p in range(D):
            sel = owner == p
            if p == d or not sel.any():
                continue
            uniq = rdp[(d, p)]
            pos = np.searchsorted(uniq, sd[sel])
            ext[sel] = B + p * H + pos
        ext_senders[d, :ne] = ext.astype(np.int32)
        loc_receivers[d, :ne] = (rd - d * B).astype(np.int32)
        edge_mask[d, :ne] = True
        is_internal[d, :ne] = local
        dinv_ext[d, :B] = dinv[d * B:(d + 1) * B]
        for p in range(D):
            if (d, p) in rdp:
                uniq = rdp[(d, p)]
                dinv_ext[d, B + p * H:B + p * H + uniq.size] = dinv[uniq]

    node_mask = _np(g.node_mask)
    node_mask = np.pad(node_mask, (0, ntot - np_pad), constant_values=False)
    node_mask = node_mask.reshape(D, B)
    n_node = node_mask.sum(axis=1).astype(np.int32)

    kw: dict[str, Any] = {}
    if split_edges:
        # the split preserves receiver order inside each list, so both local
        # segment-sums still see ascending segment ids
        counts_i = (is_internal & edge_mask).sum(axis=1)
        counts_h = (~is_internal & edge_mask).sum(axis=1)
        ei = _round_up(max(int(counts_i.max(initial=0)), 1), edge_multiple)
        eh = _round_up(max(int(counts_h.max(initial=0)), 1), edge_multiple)
        s_int = np.zeros((D, ei), np.int32)
        r_int = np.full((D, ei), B - 1, np.int32)
        int_sel = np.zeros((D, ei), np.int32)
        int_mask = np.zeros((D, ei), bool)
        s_halo = np.zeros((D, eh), np.int32)
        r_halo = np.full((D, eh), B - 1, np.int32)
        halo_sel = np.zeros((D, eh), np.int32)
        halo_mask = np.zeros((D, eh), bool)
        for d in range(D):
            ii = np.where(is_internal[d] & edge_mask[d])[0]
            hh = np.where(~is_internal[d] & edge_mask[d])[0]
            s_int[d, :ii.size] = ext_senders[d, ii]
            r_int[d, :ii.size] = loc_receivers[d, ii]
            int_sel[d, :ii.size] = ii
            int_mask[d, :ii.size] = True
            s_halo[d, :hh.size] = ext_senders[d, hh] - B  # rows of recv_flat
            r_halo[d, :hh.size] = loc_receivers[d, hh]
            halo_sel[d, :hh.size] = hh
            halo_mask[d, :hh.size] = True
        kw = dict(s_int=s_int, r_int=r_int, int_sel=int_sel,
                  int_mask=int_mask, s_halo=s_halo, r_halo=r_halo,
                  halo_sel=halo_sel, halo_mask=halo_mask)

    # per-shard sender sort (ext space); padded edges sort to the end with
    # an out-of-range key
    senders_perm = np.zeros((D, e_loc), np.int32)
    senders_sorted = np.zeros((D, e_loc), np.int32)
    recv_by_sender = np.zeros((D, e_loc), np.int32)
    mask_by_sender = np.zeros((D, e_loc), bool)
    big = np.iinfo(np.int32).max
    for d in range(D):
        key = np.where(edge_mask[d], ext_senders[d], big)
        perm = np.argsort(key, kind="stable").astype(np.int32)
        senders_perm[d] = perm
        senders_sorted[d] = key[perm]
        recv_by_sender[d] = loc_receivers[d][perm]
        mask_by_sender[d] = edge_mask[d][perm]

    return HaloPlan(n_shards=D, block=B, halo=H, e_loc=e_loc,
                    boundary_rows=boundary_rows, senders=ext_senders,
                    receivers=loc_receivers, edge_mask=edge_mask,
                    n_edge=n_edge_dev, send_idx=send_idx,
                    send_mask=send_mask, dinv_ext=dinv_ext,
                    node_mask=node_mask, n_node=n_node,
                    senders_perm=senders_perm,
                    senders_sorted=senders_sorted,
                    receivers_by_sender=recv_by_sender,
                    edge_mask_by_sender=mask_by_sender, **kw)


# ---------------------------------------------------------------- step


_SPLIT_FIELDS = ("s_int", "r_int", "int_sel", "int_mask",
                 "s_halo", "r_halo", "halo_sel", "halo_mask")
# index arrays that ops/segment.py gathers or adds with (int64 on the card)
_GATHER_FIELDS = ("s_int", "int_sel", "s_halo", "halo_sel")


def shard_graph(plan: HaloPlan, d: int, nodes=None, y=None, device="cuda",
                halo: bool = True) -> GraphBatch:
    """Shard d of the plan as a GraphBatch of B rows on `device` (with the
    stacked (D, B, ...) `nodes` and `y` when given). Its row
    pointers end at the shard's valid edges (the tail [n_edge, E) of its
    lists is padding: the receiver CSR's last row stops at n_edge, and the
    sender CSR, over the B + D*H rows of the extended space with `halo`
    (over the B local rows without), holds only valid edges), so the
    kernels that walk them leave the padded edges out. The in-degrees count
    the shard's valid in-edges, which are all of its rows' in-edges."""
    B = plan.block
    ne = int(plan.n_edge[d])
    rows_ext = B + plan.n_shards * plan.halo if halo else B
    receivers = plan.receivers[d]
    ss = plan.senders_sorted[d]

    def t(a, dtype=None):
        out = torch.from_numpy(np.ascontiguousarray(a)).to(device)
        return out if dtype is None else out.to(dtype)

    return GraphBatch(
        senders=t(plan.senders[d]), receivers=t(receivers),
        nodes=None if nodes is None else t(nodes[d]), edges=None,
        y=None if y is None else t(y[d]), node_mask=t(plan.node_mask[d]),
        edge_mask=t(plan.edge_mask[d]), graph_mask=t(np.ones(1, bool)),
        node_graph=t(np.zeros(B, np.int32)), n_node=int(plan.n_node[d]),
        n_edge=ne, n_graph=1, senders_perm=t(plan.senders_perm[d]),
        senders_sorted=t(ss), receivers_by_sender=t(plan.receivers_by_sender[d]),
        edge_mask_by_sender=t(plan.edge_mask_by_sender[d]),
        in_degrees=t(np.bincount(receivers[:ne], minlength=B).astype(np.int32)),
        recv_row_ptr=t(_row_ptr(receivers[:ne], B)),
        send_row_ptr=t(_row_ptr(ss[:ne], rows_ext)),
        graph_row_ptr=t(np.array([0, B], np.int32)))


def send_csr(send_idx: np.ndarray, send_mask: np.ndarray, block: int):
    """(row_ptr (block+1,) int32, order int32) of one rank's sent slots: the
    slots p*H + j whose send_mask holds, sorted by their local row
    send_idx[p, j] (stable: a row's slots ascending), and the row pointer
    over the block's rows. HaloExchange's backward sums the returned
    cotangents over it."""
    idx, keep = send_idx.reshape(-1), send_mask.reshape(-1)
    slots = np.flatnonzero(keep)
    order = slots[np.argsort(idx[slots], kind="stable")].astype(np.int32)
    return _row_ptr(idx[order], block), order


def _halo_state(plan: HaloPlan, d: int, group, device) -> segment.HaloState:
    """Rank d's HaloState on `device`: its plan slices, with the row pointers
    of the internal and halo edge lists over their valid prefixes and the
    CSR of its sent slots (`send_csr`)."""
    def t(a, dtype=None):
        out = torch.from_numpy(np.ascontiguousarray(a)).to(device)
        return out if dtype is None else out.to(dtype)

    kw = {}
    if plan.s_int is not None:
        kw = {f: t(getattr(plan, f)[d], torch.int64 if f in _GATHER_FIELDS else None)
              for f in _SPLIT_FIELDS}
        for name, r, m in (("int_row_ptr", plan.r_int, plan.int_mask),
                           ("halo_row_ptr", plan.r_halo, plan.halo_mask)):
            kw[name] = t(_row_ptr(r[d][:int(m[d].sum())], plan.block))
    row_ptr, order = send_csr(plan.send_idx[d], plan.send_mask[d], plan.block)
    return segment.HaloState(
        axis=group, n_local=plan.block,
        send_idx=t(plan.send_idx[d], torch.int64), send_mask=t(plan.send_mask[d]),
        dinv_ext=t(plan.dinv_ext[d]), send_row_ptr=t(row_ptr),
        send_order=t(order), **kw)


def _psum_masked_ce(logits: torch.Tensor, labels: torch.Tensor,
                    mask: torch.Tensor, group) -> torch.Tensor:
    """The global-mean masked cross entropy over the node shards (equal to
    train/losses.masked_softmax_cross_entropy on the unsharded graph):
    the numerator and the count all-reduced over the group."""
    logits = logits.float()
    ll = torch.logsumexp(logits, dim=-1) - logits.gather(
        1, labels.long()[:, None])[:, 0]
    m = mask.float()
    num = segment.all_reduce_sum((ll * m).sum(), group)
    den = segment.all_reduce(m.sum(), group=group)
    return num / den.clamp_min(1.0)


def average_grads(params, group, n: int) -> None:
    """Replace each parameter's gradient by its mean over the group's n
    ranks, in one all-reduce of the flattened gradients (a parameter
    without a gradient takes part as zeros and keeps none)."""
    grads = [p.grad if p.grad is not None else torch.zeros_like(p)
             for p in params]
    flat = segment.all_reduce(torch.cat([gr.reshape(-1) for gr in grads]),
                              group=group) / n
    at = 0
    for p in params:
        k = p.numel()
        if p.grad is not None:
            p.grad.copy_(flat[at:at + k].view_as(p))
        at += k


def _padded_mask(mask, n: int, device) -> torch.Tensor:
    m = _np(mask).astype(bool)
    if m.shape[0] < n:
        m = np.pad(m, (0, n - m.shape[0]), constant_values=False)
    return torch.from_numpy(m[:n]).to(device)


def _eval_on(model, g: GraphBatch, em: torch.Tensor):
    """(loss, accuracy) of one eval-mode forward over the masked rows."""
    model.eval()
    with torch.no_grad():
        out = model(g).float()
        y = g.y.long()
        m = em.float()
        loss = losses.masked_softmax_cross_entropy(out, y, em)
        acc = ((out.argmax(1) == y).float() * m).sum() / m.sum().clamp_min(1.0)
    return loss, acc


def _make_singleton_step_direct(model, optimizer, g: GraphBatch, mask):
    """n_shards=1 with the node layout of the input batch: train and eval
    on the original batch, with no repacking (the unsharded step), moved to
    the model's device if it is elsewhere."""
    device = next(model.parameters()).device
    if g.device != device:
        g = g.to(device)
    loss_mask = _padded_mask(mask, g.n_node_pad, device)
    train_step, _ = make_node_steps(model, optimizer)

    def step():
        return train_step(g, loss_mask)

    def evaluate(eval_mask):
        return _eval_on(model, g, _padded_mask(eval_mask, g.n_node_pad, device))

    return step, evaluate


def _make_singleton_step(model, optimizer, plan: HaloPlan, g: GraphBatch, mask):
    """n_shards=1 on the plan's local layout: the plain (unsharded) step on
    the plan's single shard."""
    device = next(model.parameters()).device
    g_loc = shard_graph(plan, 0, plan.shard_nodes(_np(g.nodes)),
                         plan.shard_nodes(_np(g.y)), device, halo=False)
    loss_mask = torch.from_numpy(plan.shard_nodes(_np(mask), fill=False)[0]).to(device)
    train_step, _ = make_node_steps(model, optimizer)

    def step():
        return train_step(g_loc, loss_mask)

    def evaluate(eval_mask):
        em = plan.shard_nodes(_np(eval_mask), fill=False)[0]
        return _eval_on(model, g_loc, torch.from_numpy(em).to(device))

    return step, evaluate


def rank_generator(seed: int, rank: int, device) -> torch.Generator:
    """The dropout generator of one rank (the port's counterpart of the JAX
    step's fold_in(key, axis_index)): each rank draws its own masks."""
    return torch.Generator(device=device).manual_seed(
        (int(seed) + 1) * 1_000_003 + int(rank))


def make_halo_node_step(model, optimizer, plan: HaloPlan, g: GraphBatch,
                        mask, group=None, force_full: bool = False):
    """One rank's halo-partitioned full-graph node-classification train
    step. Returns (step() -> loss, evaluate(eval_mask) -> (loss,
    accuracy)): the graph and mask are taken apart at build time (full-batch
    training reuses the same graph every step); evaluate's mask is the
    global (Np,) or (N,) one, and its loss and accuracy use the running
    statistics. Every rank of `group` (the default group when None) calls
    this with the same plan, graph and weights; rank d takes shard d.

    With one shard and no boundary the step is the unsharded one (no
    exchange, no collective; `group` need not exist), on the input batch
    when the plan's layout matches it. `force_full=True` keeps the whole
    machinery at one shard, so that its cost stays measurable."""
    if (plan.n_shards == 1 and plan.boundary_rows == 0 and not force_full):
        if plan.block == g.n_node_pad:
            return _make_singleton_step_direct(model, optimizer, g, mask)
        return _make_singleton_step(model, optimizer, plan, g, mask)
    group = dist.group.WORLD if group is None else group
    D = dist.get_world_size(group)
    if D != plan.n_shards:
        raise ValueError(f"the plan has {plan.n_shards} shards and the "
                         f"group {D} ranks")
    rank = dist.get_rank(group)
    device = next(model.parameters()).device
    g_loc = shard_graph(plan, rank, plan.shard_nodes(_np(g.nodes)),
                         plan.shard_nodes(_np(g.y)), device)
    hs = _halo_state(plan, rank, group, device)
    loss_mask = torch.from_numpy(plan.shard_nodes(_np(mask), fill=False)[rank]).to(device)
    params = list(model.parameters())
    if getattr(model, "dropout", 0.0) > 0.0:
        model._dropout_gen = rank_generator(model.seed, rank, device)

    def step():
        model.train()
        optimizer.zero_grad(set_to_none=True)
        with segment.halo_mode(hs):
            out = model(g_loc)
            loss = _psum_masked_ce(out, g_loc.y, loss_mask, group)
        loss.backward()
        average_grads(params, group, D)
        optimizer.step()
        return loss.detach()

    def evaluate(eval_mask):
        em = torch.from_numpy(plan.shard_nodes(_np(eval_mask), fill=False)[rank]).to(device)
        model.eval()
        with torch.no_grad(), segment.halo_mode(hs):
            out = model(g_loc)
            loss = _psum_masked_ce(out, g_loc.y, em, group)
            m = em.float()
            correct = ((out.argmax(1) == g_loc.y.long()).float() * m).sum()
            acc = (segment.all_reduce(correct, group=group)
                   / segment.all_reduce(m.sum(), group=group).clamp_min(1.0))
        return loss, acc

    return step, evaluate


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def halo_scaling_report_rank(rank: int, world: int, model_fn, n: int,
                             iters: int) -> dict:
    """One rank's share of `halo_scaling_report` at n = world shards (a
    dist/launch.py rank): the plan, a warm-up step, then `iters` timed
    steps. model_fn() -> (model, optimizer, g, mask). Returns the row (its
    seconds this rank's)."""
    group = None
    model, optimizer, g, mask = model_fn()
    plan = build_halo_plan(g, n)
    step, _ = make_halo_node_step(model, optimizer, plan, g, mask, group=group)
    device = next(model.parameters()).device
    step()
    _sync(device)
    if dist.is_initialized():
        dist.barrier(group)
    t0 = time.perf_counter()
    for _ in range(iters):
        loss = step()
    _sync(device)
    sec = (time.perf_counter() - t0) / iters
    return {"n_devices": n, "sec_per_step": sec,
            "edges_per_s": int(g.n_edge) / sec,
            "halo_rows_per_dev": plan.comm_rows_per_device(),
            "boundary_rows": plan.boundary_rows, "block": plan.block,
            "loss": float(loss)}


def halo_scaling_report(model_fn, n_devices_list=(1, 2, 4, 8), iters: int = 5,
                        backend: str = "nccl", device: str = "cuda",
                        timeout: float = 1800.0) -> list:
    """edges/s of the halo-partitioned step at several shard counts, each
    run as that many ranks (dist/launch.py) of `backend`. model_fn must be
    a module-level function (the ranks import it) returning (model,
    optimizer, g, mask) on its rank's device. Every count is checked before
    the first run: NCCL asked for more ranks than there are cards raises
    (dist/launch.py's check_backend); gloo ranks may share one card, and
    then their times measure the partition's cost, not scaling. Each row's
    seconds are the slowest rank's."""
    from kagnn_tpu_torch.dist.launch import check_backend, launch

    for n in n_devices_list:
        check_backend(backend, n, device)
    rows = []
    for n in n_devices_list:
        got = launch(halo_scaling_report_rank, n, (model_fn, n, iters),
                     backend=backend, device=device, timeout=timeout)
        row = dict(got[0])
        row["sec_per_step"] = max(r["sec_per_step"] for r in got)
        row["edges_per_s"] = row["edges_per_s"] * got[0]["sec_per_step"] / row["sec_per_step"]
        rows.append(row)
    if rows:
        base = rows[0]["edges_per_s"]
        for r in rows:
            r["scaling_efficiency"] = r["edges_per_s"] / (base * r["n_devices"])
    return rows
