"""Drives of the three strategies, one function a rank, for
`dist/launch.py`: the halo-partitioned and edge-partitioned node steps
(`node_rank`) and the data-parallel graph step (`dp_rank`), and their
single-card counterparts from the same weights (`node_single`,
`dp_single`), which the tests and chip_smoke.py hold them against.

A run is described by a picklable dict (`spec`) of numpy arrays and plain
values, so that each rank builds its own graph, model and step from it:

  graph     {"senders", "receivers", "nodes", "y", "n_node"} arrays, or
            {"arxiv_seed": s} for data/synthetic.arxiv_scale_graph(seed=s);
  reorder   "none" or "rcm" (graphs/reorder.py's bfs_order);
  model     NodeClassifier's keywords, with "dtype" "float32" or "bfloat16";
  state     a state_dict of numpy arrays to load, or None (the seed's);
  opt       ("adam", lr) or ("sgd", lr);
  mask      the loss mask (None: every valid node);
  steps, warmup
            train steps in all, of which the first `warmup` are not timed;
  strategy  "halo" or "edge"; force_full (halo); eval_mask (halo) or None;
  group_ranks
            the ranks of a subgroup that runs it (None: all of them);
  profile   profile 3 more steps on the card after the counted ones;
  device    "cpu" or "cuda".

`exchange_rank` and `entry_rank` drive the halo exchange and the two
halo entries of the fused GIN kernels alone, `fusion_rank` (and
`fusion_single`) the GIN+FastKAN fusion point under the halo partition,
`mesh_rank` the rank layouts, `init_rank` the multi-host bootstrap and
`gloo_probe_rank` what gloo does with tensors on the card.

A rank returns its losses, the gradients after the first step (the
averaged ones every rank applies), its logits of the first forward (its
shard's rows under halo), its parameters after the last step, the launches
of its kernels over the steps, ms per timed step, peak device memory and
the plan's statistics.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from kagnn_tpu_torch.data.synthetic import arxiv_scale_graph
from kagnn_tpu_torch.graphs import single_graph
from kagnn_tpu_torch.kernels import launch_counters

DTYPES = {"float32": None, "bfloat16": torch.bfloat16}


def graph_data(spec: dict) -> dict:
    """The spec's graph as single_graph's arrays, reordered if asked."""
    gd = spec["graph"]
    if "arxiv_seed" in gd:
        gd = arxiv_scale_graph(seed=gd["arxiv_seed"])
    if spec.get("reorder", "none") == "rcm":
        from kagnn_tpu_torch.graphs.reorder import bfs_order, reorder_graph

        gd = reorder_graph(dict(gd), bfs_order)
    return gd


def make_graph(spec: dict, device):
    gd = graph_data(spec)
    return single_graph(gd["senders"], gd["receivers"], nodes=gd["nodes"],
                        y=gd["y"], n_node=int(gd["n_node"]), device=device)


def make_model(spec: dict, device):
    from kagnn_tpu_torch.models import NodeClassifier

    kw = dict(spec["model"])
    kw["compute_dtype"] = DTYPES[kw.pop("dtype", "float32")]
    model = NodeClassifier(device=device, **kw)
    if spec.get("state") is not None:
        model.load_state_dict({k: torch.as_tensor(v) for k, v in spec["state"].items()})
    return model


def make_optimizer(spec: dict, model):
    name, lr = spec.get("opt", ("adam", 1e-3))
    cls = {"adam": torch.optim.Adam, "sgd": torch.optim.SGD}[name]
    return cls(model.parameters(), lr=lr)


def loss_mask(spec: dict, g) -> np.ndarray:
    m = spec.get("mask")
    if m is None:
        return g.node_mask.cpu().numpy()
    m = np.asarray(m, bool)
    return np.pad(m, (0, g.n_node_pad - m.shape[0])) if m.shape[0] < g.n_node_pad else m


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy()


def _keep_first(seen: dict):
    """A forward hook that keeps the first output (as host f32)."""
    def hook(module, args, out):
        if "logits" not in seen:
            seen["logits"] = _host(out)
    return hook


def _zero_counters():
    fns = launch_counters()
    for f in fns.values():
        f.launches = 0
    return fns


def _timed_steps(spec, device, step):
    """spec's steps through step(); (losses, ms per timed step)."""
    steps, warmup = int(spec.get("steps", 1)), int(spec.get("warmup", 0))
    losses, t0 = [], None
    for i in range(steps):
        if i == warmup:
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            t0 = time.perf_counter()
        losses.append(float(step()))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    timed = steps - warmup
    ms = (time.perf_counter() - t0) * 1e3 / timed if timed > 0 else None
    return losses, ms


def node_rank(rank: int, world: int, spec: dict) -> dict:
    """One rank of the halo- or edge-partitioned node step (see the module
    docstring)."""
    import torch.distributed as dist

    from kagnn_tpu_torch.dist.halo import build_halo_plan, make_halo_node_step
    from kagnn_tpu_torch.dist.partition import make_edge_partitioned_node_step

    device = torch.device(spec.get("device", "cuda"))
    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    halo = spec["strategy"] == "halo"
    g = make_graph(spec, "cpu" if halo else device)
    mask = loss_mask(spec, g)
    model = make_model(spec, device)
    opt = make_optimizer(spec, model)
    out = {"rank": rank, "world": world}
    group, n = None, world
    if spec.get("group_ranks") is not None:
        # a subgroup of the world (every rank makes it); the rest wait
        members = [int(r) for r in spec["group_ranks"]]
        group, n = dist.new_group(members), len(members)
        if rank not in members:
            dist.barrier()
            return None
    if halo:
        plan = build_halo_plan(g, n, **spec.get("plan_kw", {}))
        step, evaluate = make_halo_node_step(model, opt, plan, g, mask, group=group,
                                             force_full=spec.get("force_full", False))
        out.update(block=plan.block, halo=plan.halo, boundary_rows=plan.boundary_rows,
                   comm_rows_per_device=plan.comm_rows_per_device(),
                   shard_edges=[int(v) for v in plan.n_edge], e_loc=plan.e_loc)
    else:
        mask_t = torch.from_numpy(mask).to(device)
        estep = make_edge_partitioned_node_step(model, opt, group)
        step = lambda: estep(g, mask_t)  # noqa: E731
    seen = {}
    hook = model.register_forward_hook(_keep_first(seen))
    grads = {}

    def first_step():
        loss = step()
        if not grads:
            grads.update({n: _host(p.grad) for n, p in model.named_parameters()
                          if p.grad is not None})
        return loss

    fns = _zero_counters()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    losses, ms = _timed_steps(spec, device, first_step)
    hook.remove()
    out.update(losses=losses, ms=ms, grads=grads, logits=seen["logits"],
               launches={k: f.launches for k, f in fns.items()},
               params=np.concatenate([_host(p).reshape(-1) for p in model.parameters()]),
               peak_gib=(torch.cuda.max_memory_allocated(device) / 2**30
                         if device.type == "cuda" else None))
    if halo and spec.get("eval_mask") is not None:
        loss, acc = evaluate(np.asarray(spec["eval_mask"], bool))
        out["eval"] = (float(loss), float(acc))
    if spec.get("profile") and device.type == "cuda":
        # after the counted steps: device ms a step by kernel and host ms by
        # operator over 3 more steps (utils/profiling.device_profile)
        from kagnn_tpu_torch.utils.profiling import device_profile

        prof = device_profile(lambda: [step() for _ in range(3)], 3)
        out["profile"] = dict(device_ms=prof.ms, kernels=prof.kernels[:8],
                              host_ms=sum(t for _, t, _ in prof.host),
                              host=prof.host[:8])
    if dist.is_initialized():
        dist.barrier()
    return out


def node_single(spec: dict, device) -> dict:
    """The single-card step from the spec's weights: the same losses,
    first-step gradients and logits as `node_rank` collects, and the eval
    (loss, accuracy) with the running statistics after the steps."""
    from kagnn_tpu_torch.train import losses as L
    from kagnn_tpu_torch.train import make_node_steps

    device = torch.device(device)
    g = make_graph(spec, device)
    mask = torch.from_numpy(loss_mask(spec, g)).to(device)
    model = make_model(spec, device)
    opt = make_optimizer(spec, model)
    train_step, _ = make_node_steps(model, opt)
    seen, grads = {}, {}
    hook = model.register_forward_hook(_keep_first(seen))

    def step():
        loss = train_step(g, mask)
        if not grads:
            grads.update({n: _host(p.grad) for n, p in model.named_parameters()
                          if p.grad is not None})
        return loss

    losses, ms = _timed_steps(spec, device, step)
    hook.remove()
    out = dict(losses=losses, ms=ms, grads=grads, logits=seen["logits"],
               n_node_pad=g.n_node_pad,
               params=np.concatenate([_host(p).reshape(-1) for p in model.parameters()]))
    if spec.get("eval_mask") is not None:
        em = torch.from_numpy(loss_mask(dict(mask=spec["eval_mask"]), g)).to(device)
        model.eval()
        with torch.no_grad():
            logits = model(g).float()
            m = em.float()
            acc = ((logits.argmax(1) == g.y.long()).float() * m).sum() / m.sum().clamp_min(1.0)
            out["eval"] = (float(L.masked_softmax_cross_entropy(logits, g.y, em)), float(acc))
    return out


def stitch_logits(ranks: list, n_node_pad: int) -> np.ndarray:
    """The halo ranks' shard logits in global row order (shard d holds rows
    [d*B, (d+1)*B)), cut to the single graph's padded rows."""
    return np.concatenate([r["logits"] for r in sorted(ranks, key=lambda r: r["rank"])])[:n_node_pad]


# --- data parallelism -------------------------------------------------------

def dp_batches(spec: dict, device) -> list:
    """The replicas' batches of molecules (data/synthetic's
    random_molecule_graphs, one-hot atom types), one PadSpec for all."""
    from kagnn_tpu_torch.data.synthetic import random_molecule_graphs
    from kagnn_tpu_torch.graphs import batch_graphs, pad_spec_for

    per = int(spec["batch"])
    n = per * int(spec["replicas"])
    graphs = random_molecule_graphs(n_graphs=n, seed=int(spec.get("seed", 1)))
    for gr in graphs:
        gr["nodes"] = np.eye(spec["model"]["num_features"], dtype=np.float32)[gr["nodes"][:, 0]]
    pad = pad_spec_for(graphs, per)
    return [batch_graphs(graphs[i * per:(i + 1) * per], pad, device=device)
            for i in range(int(spec["replicas"]))]


def dp_model(spec: dict, device):
    from kagnn_tpu_torch.models import GraphClassifier

    kw = dict(spec["model"])
    kw["compute_dtype"] = DTYPES[kw.pop("dtype", "float32")]
    model = GraphClassifier(device=device, **kw)
    if spec.get("state") is not None:
        model.load_state_dict({k: torch.as_tensor(v) for k, v in spec["state"].items()})
    return model


def dp_loss(out, batch):
    from kagnn_tpu_torch.train.losses import masked_nll

    return masked_nll(out, batch.y, batch.graph_mask)


def dp_rank(rank: int, world: int, spec: dict) -> dict:
    """One rank of the data-parallel graph-classification step over
    `spec["replicas"]` batches of `spec["batch"]` molecules (GraphClassifier
    with spec["model"]'s keywords; spec["mesh"] the (data, graph) shape)."""
    from kagnn_tpu_torch.dist.mesh import make_mesh
    from kagnn_tpu_torch.dist.sharded import make_sharded_train_step, stack_batches

    device = torch.device(spec.get("device", "cuda"))
    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    stacked = stack_batches(dp_batches(spec, device))
    model = dp_model(spec, device)
    opt = make_optimizer(spec, model)
    mesh = make_mesh(spec.get("mesh", (world, 1)), ("data", "graph"))
    step = make_sharded_train_step(model, opt, dp_loss, mesh)
    grads, stats = {}, {}

    def first_step():
        loss = step(stacked)
        if not grads:
            grads.update({n: _host(p.grad) for n, p in model.named_parameters()
                          if p.grad is not None})
            stats.update({n: _host(b) for n, b in model.named_buffers() if "running" in n})
        return loss

    fns = _zero_counters()
    losses, ms = _timed_steps(spec, device, first_step)
    return dict(rank=rank, losses=losses, ms=ms, grads=grads, stats=stats,
                launches={k: f.launches for k, f in fns.items()},
                params=np.concatenate([_host(p).reshape(-1) for p in model.parameters()]))


def dp_single(spec: dict, device) -> dict:
    """The single-card counterpart of one DP step: the mean of the
    replicas' losses, its gradients, and the mean of the running statistics
    each replica's forward leaves (from the same starting statistics)."""
    device = torch.device(device)
    batches = dp_batches(spec, device)
    model = dp_model(spec, device)
    start = {n: b.clone() for n, b in model.named_buffers() if "running" in n}
    model.train()
    total, stats = 0.0, {n: 0.0 for n in start}
    for b in batches:
        for n, buf in model.named_buffers():
            if n in start:
                buf.copy_(start[n])
        total = total + dp_loss(model(b), b)
        for n, buf in model.named_buffers():
            if n in start:
                stats[n] = stats[n] + _host(buf)
    loss = total / len(batches)
    loss.backward()
    return dict(loss=float(loss.detach()),
                grads={n: _host(p.grad) for n, p in model.named_parameters()
                       if p.grad is not None},
                stats={n: v / len(batches) for n, v in stats.items()})


# --- the exchange and the halo entries alone ---------------------------------

def _shard_setup(spec: dict, rank: int, world: int, device):
    """The spec's graph, its plan over the world, and this rank's local graph
    (with its node rows) and HaloState (on the default group)."""
    import torch.distributed as dist

    from kagnn_tpu_torch.dist.halo import _halo_state, build_halo_plan, shard_graph

    g = make_graph(spec, "cpu")
    plan = build_halo_plan(g, world)
    g_loc = shard_graph(plan, rank, plan.shard_nodes(g.nodes.numpy()), device=device)
    return plan, g_loc, _halo_state(plan, rank, dist.group.WORLD, device)


def exchange_rank(rank: int, world: int, spec: dict) -> dict:
    """`ops.segment.halo_exchange` of spec["x"] (global (Np, F) rows) and its
    backward for a cotangent of the received rows drawn from
    spec["seed"] + rank: (recv, cot, dx) of this rank."""
    from kagnn_tpu_torch.ops import segment

    device = torch.device(spec.get("device", "cpu"))
    plan, _, hs = _shard_setup(spec, rank, world, device)
    x = torch.from_numpy(plan.shard_nodes(spec["x"])[rank]).to(device).requires_grad_(True)
    with segment.halo_mode(hs):
        recv = segment.halo_exchange(x)
    cot = torch.from_numpy(np.random.default_rng(spec["seed"] + rank).normal(
        size=tuple(recv.shape)).astype(np.float32)).to(device)
    recv.backward(cot)
    return dict(recv=_host(recv), cot=_host(cot), dx=_host(x.grad))


def entry_rank(rank: int, world: int, spec: dict) -> dict:
    """One halo entry of the fused GIN kernels (spec["kind"] "kan":
    `gin_kan_fused_halo`, "fastkan": `gin_fastkan_fused_halo`) on this
    rank's shard of spec["x"], in spec["dtype"], with spec["weights"] (the
    module's layouts) and the loss sum(out * cot): the shard's output, the
    gradient of x (the exchange carries the halo rows' share to their
    owners) and the weight gradients summed over the ranks."""
    from kagnn_tpu_torch.kernels.gin_fastkan import gin_fastkan_fused_halo
    from kagnn_tpu_torch.kernels.gin_fused import gin_kan_fused_halo
    from kagnn_tpu_torch.ops import segment

    device = torch.device(spec.get("device", "cpu"))
    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    dt = DTYPES[spec.get("dtype", "float32")] or torch.float32
    plan, g_loc, hs = _shard_setup(spec, rank, world, device)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    x = t(plan.shard_nodes(spec["x"])[rank]).to(dt).requires_grad_(True)
    cot = t(plan.shard_nodes(spec["cot"])[rank])
    w = {k: t(v).to(dt).requires_grad_(k != "grid") for k, v in spec["weights"].items()}
    with segment.halo_mode(hs):
        if spec["kind"] == "kan":
            out = gin_kan_fused_halo(x, g_loc, spec["eps"], w["grid"], w["base_weight"],
                                     w["scaled_spline_weight"], spec["spline_order"])
        else:
            out = gin_fastkan_fused_halo(x, g_loc, spec["eps"], w["ln_scale"], w["ln_bias"],
                                         w["spline_weight"], w["base_weight"],
                                         w["base_bias"], -2.0, 2.0, spec["num_grids"])
    (out.float() * cot).sum().backward()
    dw = {k: _host(segment.all_reduce(v.grad.float(), group=hs.axis))
          for k, v in w.items() if v.grad is not None}
    return dict(out=_host(out), dx=_host(x.grad), dw=dw)


def _fusion_net(spec: dict, device):
    from kagnn_tpu_torch.kan import FastKAN

    return FastKAN(spec["widths"], num_grids=spec["num_grids"], fused=True,
                   compute_dtype=DTYPES[spec.get("dtype", "float32")], device=device)


def fusion_rank(rank: int, world: int, spec: dict) -> dict:
    """The GIN+FastKAN fusion point under the halo partition:
    FastKAN(spec["widths"], fused)(x, gin_graph=(g, 0)) on this rank's shard
    of spec["graph"] (its node rows as x), forward and the backward of the
    sum of its valid rows' outputs, once and counted: the shard's output,
    the gradient of x, the weight gradients summed over the ranks and the
    launches."""
    from kagnn_tpu_torch.ops import segment

    device = torch.device(spec.get("device", "cuda"))
    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    _, g_loc, hs = _shard_setup(spec, rank, world, device)
    net = _fusion_net(spec, device)
    x = g_loc.nodes.clone().requires_grad_(True)
    fns = _zero_counters()
    with segment.halo_mode(hs):
        out = net(x, gin_graph=(g_loc, 0.0))
    out[g_loc.node_mask].float().sum().backward()
    return dict(rank=rank, out=_host(out), dx=_host(x.grad),
                launches={k: f.launches for k, f in fns.items()},
                dw={n: _host(segment.all_reduce(p.grad, group=hs.axis))
                    for n, p in net.named_parameters()})


def fusion_single(spec: dict, device) -> dict:
    """`fusion_rank`'s drive on one card over the whole graph."""
    device = torch.device(device)
    g = make_graph(spec, device)
    net = _fusion_net(spec, device)
    x = g.nodes.clone().requires_grad_(True)
    out = net(x, gin_graph=(g, 0.0))
    out[g.node_mask].float().sum().backward()
    return dict(out=_host(out), dx=_host(x.grad), n_node_pad=g.n_node_pad,
                dw={n: _host(p.grad) for n, p in net.named_parameters()})


def gloo_probe_rank(rank: int, world: int, spec: dict) -> dict:
    """Whether the gloo backend takes tensors on the card itself for
    all_to_all_single and all_reduce (ops/segment.py hands them to it where
    they are): a report of what each call did. Run it last in a group: a refusal leaves it as
    it was only if every rank refuses alike."""
    import torch.distributed as dist

    t = torch.arange(2.0 * world, device="cuda") + rank
    calls = {"all_to_all_single": lambda: dist.all_to_all_single(torch.empty_like(t), t),
             "all_reduce": lambda: dist.all_reduce(t.clone())}
    out = {}
    for name, call in calls.items():
        try:
            call()
            torch.cuda.synchronize()
            out[name] = "takes CUDA tensors"
        except (RuntimeError, ValueError) as e:
            out[name] = f"refuses them: {str(e).splitlines()[0][:160]}"
    return out


def init_rank(rank: int, world: int, spec: dict) -> dict:
    """`dist.init.initialize_multihost` inside a rank: a no-op while the
    launcher's group exists; then, that group destroyed, a new one from the
    JAX module's environment names (spec["env"], with PROCESS_ID this
    rank's), checked by an all-reduce of the ranks' ids."""
    import os

    import torch.distributed as dist

    from kagnn_tpu_torch.dist.init import initialize_multihost

    before = dist.group.WORLD
    initialize_multihost(backend="gloo")
    kept = dist.group.WORLD is before
    dist.destroy_process_group()
    os.environ.update(spec["env"], PROCESS_ID=str(rank))
    initialize_multihost(backend="gloo")
    total = torch.tensor([float(rank)])
    dist.all_reduce(total)
    return dict(kept=kept, world=dist.get_world_size(), rank=dist.get_rank(),
                total=float(total))


def mesh_rank(rank: int, world: int, spec: dict) -> dict:
    """`dist.mesh.make_mesh(spec["shape"])` seen from this rank: its
    coordinates, and each axis's size and, through an all-reduce of the
    ranks over the axis's group, the ranks on its line."""
    import torch.distributed as dist

    from kagnn_tpu_torch.dist.mesh import make_mesh
    from kagnn_tpu_torch.ops import segment

    mesh = make_mesh(spec["shape"], spec.get("axes", ("data", "graph")))
    lines = {}
    for ax in mesh.axis_names:
        onehot = torch.zeros(world)
        onehot[rank] = 1.0
        grp = mesh.group(ax)
        lines[ax] = (segment.all_reduce(onehot, group=grp) if grp is not None
                     else onehot).nonzero().flatten().tolist()
    dist.barrier()
    return dict(coords=mesh.coords, sizes=[mesh.size(a) for a in mesh.axis_names],
                lines=lines)


RANK_FNS = {"node": node_rank, "dp": dp_rank, "exchange": exchange_rank,
            "entry": entry_rank, "mesh": mesh_rank, "fusion": fusion_rank,
            "gloo_probe": gloo_probe_rank}


def many_rank(rank: int, world: int, jobs: list) -> list:
    """Several drives in one process group, in order: jobs is a list of
    (kind, spec), kind a key of RANK_FNS. One spawn then serves every
    configuration of a test file."""
    return [RANK_FNS[kind](rank, world, spec) for kind, spec in jobs]
