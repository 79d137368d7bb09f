"""Does the halo flagship step repeat bit for bit, and what does a step
cost? The flagship (gin/kan fused, bf16, the main path's widths, Adam 1e-3)
on the arxiv-sized graph in 4 node shards, 4 gloo ranks, each mode run
twice from the same weights in one spawn:

  cpu             the ranks' tensors on the CPU (the plain versions);
  cuda-index_add  on the card, HaloExchange's backward summing the returned
                  cotangents with `index_add_` (float atomics, the port's
                  backward before the plan's sorted CSR of the sent slots);
  cuda            on the card, the port's backward (the segment-sum kernel
                  over that CSR, no float atomics).

For each mode it prints whether the two runs' losses, first-step gradients
and final parameters are bit-equal (and how far apart they are when not),
and each run's ms a step on rank 0 (host clock over the timed steps, ending
in a synchronize). The ranks share one card: the times are the partition's
cost on that card, not scaling.

    python -m kagnn_tpu_torch.utils.time_halo [--modes cpu cuda-index_add cuda]
        [--steps 5] [--warmup 2] [--cpu_steps 2]

The `cuda-index_add` mode is the backward as it was before the sorted
sum, so the two modes of one run are the paired before and after.
"""
from __future__ import annotations

import argparse
import json

import numpy as np

RANKS = 4
FLAGSHIP = dict(mp_layers=3, num_features=128, hidden_channels=64,
                num_classes=40, grid_size=4, spline_order=3, skip=False,
                hidden_layers=2, heads=4, dropout=0.0, conv_type="gin",
                architecture="kan", fused=True, dtype="bfloat16", seed=0)


def _index_add_backward(ctx, cot):
    """HaloExchange's backward as it was: the cotangents returned to this
    rank added into their sent rows by `index_add_` (in f32 atomics on the
    card, in a new order each run)."""
    import torch

    from kagnn_tpu_torch.kernels._common import segment_ids
    from kagnn_tpu_torch.ops import segment

    row_ptr, order = ctx.saved_tensors
    back = segment._all_to_all(cot.contiguous(), ctx.group)
    rows = segment_ids(row_ptr)
    dx = torch.zeros((row_ptr.numel() - 1,) + tuple(back.shape[1:]),
                     dtype=back.dtype, device=back.device)
    dx.index_add_(0, rows, back.index_select(0, order.long()))
    return dx, None, None, None, None, None


def probe_rank(rank: int, world: int, jobs: list) -> list:
    """dist/runs.py's node_rank for each (backward, spec) of jobs, with
    HaloExchange's backward swapped for `_index_add_backward` where asked."""
    from kagnn_tpu_torch.dist import runs
    from kagnn_tpu_torch.ops import segment

    sorted_backward = segment.HaloExchange.backward
    out = []
    for backward, spec in jobs:
        segment.HaloExchange.backward = (staticmethod(_index_add_backward)
                                         if backward == "index_add"
                                         else sorted_backward)
        try:
            out.append(runs.node_rank(rank, world, spec))
        finally:
            segment.HaloExchange.backward = sorted_backward
    return out


def _spec(device: str, steps: int, warmup: int) -> dict:
    return dict(graph={"arxiv_seed": 0}, model=dict(FLAGSHIP), opt=("adam", 1e-3),
                steps=steps, warmup=warmup, strategy="halo", device=device)


def _apart(a, b) -> float:
    return float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max())


def compare(mode: str, first: dict, second: dict) -> dict:
    """The two runs of one mode on rank 0."""
    grads = {k: np.array_equal(first["grads"][k], second["grads"][k])
             for k in first["grads"]}
    return dict(
        mode=mode, losses=[first["losses"], second["losses"]],
        losses_equal=first["losses"] == second["losses"],
        losses_apart=_apart(first["losses"], second["losses"]),
        grads_equal=all(grads.values()),
        grads_apart=max(_apart(first["grads"][k], second["grads"][k]) for k in grads),
        params_equal=bool(np.array_equal(first["params"], second["params"])),
        params_apart=_apart(first["params"], second["params"]),
        ms=[first["ms"], second["ms"]])


def main(argv=None) -> list:
    from kagnn_tpu_torch.dist.launch import launch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--modes", nargs="+", default=["cpu", "cuda-index_add", "cuda"],
                    choices=["cpu", "cuda-index_add", "cuda"])
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--warmup", type=int, default=2)
    ap.add_argument("--cpu_steps", type=int, default=2,
                    help="steps of the cpu mode (each takes seconds)")
    args = ap.parse_args(argv)
    report = []
    for device in ("cpu", "cuda"):
        modes = [m for m in args.modes if m.split("-")[0] == device]
        if not modes:
            continue
        steps = args.cpu_steps if device == "cpu" else args.steps
        warmup = min(args.warmup, steps - 1)
        jobs = [("index_add" if m.endswith("index_add") else "sorted",
                 _spec(device, steps, warmup)) for m in modes for _ in range(2)]
        res = launch(probe_rank, RANKS, (jobs,), backend="gloo", device=device,
                     timeout=1800)
        r0 = res[0]
        for i, m in enumerate(modes):
            row = compare(m, r0[2 * i], r0[2 * i + 1])
            print(json.dumps(row), flush=True)
            report.append(row)
    return report


if __name__ == "__main__":
    main()
