#!/usr/bin/env python3
"""On-card smoke check of the PyTorch/CUDA port (`kagnn_tpu_torch`).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases (any failure raises, and the script exits non-zero):
  1. device: requires CUDA, prints the card's name and power limit, turns
     TF32 off for matmul and cuDNN;
  2. build: compiles every CUDA kernel from `kagnn_tpu_torch/csrc/` (one
     nvcc per library, all at once: a layer source is a library per shape,
     the main paths' and the search-space corners' below) and prints the
     build time;
  3. kernels: each of the 14 kernels against its plain PyTorch version on
     the card, at small shapes, ragged shapes (N off every tile, isolated
     nodes, a node of in-degree 301, receivers past the last segment) and
     the main paths' shapes (the layer kernels also at the GAT transform's
     widths, 256 = 4 heads x 64; the RBF kernels at the base-free FastKAN's
     widths with x/w in f32/f32, f32/bf16 and bf16/bf16, with the kernel
     each launches by its profiled name; the narrow sum at k 1-8 on the
     split's cases (`selfcheck.narrow_cases`: hub rows at a chunk's head,
     inside a chunk and after dropped edges, rows of 64 and 65 edges,
     receivers past the end, no edge) and at k = 4 over the arxiv-sized
     graph's receivers, its row pointer against torch.searchsorted exactly
     and its sums against the function summed in f64 (node 0's hub row
     too), bit for bit twice, timed whole, its row pointer alone and by
     kernel; spmm also over the
     receiver CSR with idx = senders at the gin/fastkan step's widths, timed
     beside torch.sparse.mm and on its hub row alone and its light rows
     alone, and on a graph whose both CSRs hold heavy rows, at 1-300
     columns, bit for bit twice; gin_fused, which splits receiver rows of
     more than 64 edges, on that graph at 7-300 columns, bit for bit twice,
     with the kernels it launches by dtype, and on the main graph's hub row
     alone and light rows alone, timed; gin_fastkan, split the same way, on
     that graph at 7-300 columns and 4 and 32 centers against its plain
     function on the exactly summed z, bit for bit twice, and like gin_fused
     on the main graph; gcn_agg also on a hub row
     of 100,000 in-edges, on a graph of light rows and on the main graph's
     hub row alone, timed, and at D 42, one value a lane; gat_fwd and
     gat_dadst, which split rows of more than 64 valid edges, also on
     graphs built for each branch of that split, bit for bit twice, and on
     the main graph's hub row and light rows apart, timed; gat_sender, which
     splits heavy sender rows, on those graphs reversed, bit for bit twice,
     and over the main graph's receiver CSR walked as a sender CSR, whole,
     hub row and light rows apart, timed), in f32 and bf16
     (a bf16 weight gradient summed over more than one row tile against
     the plain walk, `selfcheck.dw_walk_check`, with two wrong reduces that
     must fail it at the main shapes' 1,323 B-spline and 331 FastKAN and RBF
     tiles; over one, the 4-ulp bar of every kernel), with
     times (CUDA events) for the kernel, the plain version and, where one
     PyTorch call computes the same function, that call as the library
     yardstick (`torch.sparse.mm` on a CSR matrix; the port never calls it;
     there is none for GAT attention or the RBF product); at the main
     shapes each layer forward's profiled kernel (the tensor-core kernel
     in bf16, the CUDA-core one in f32: the phase fails otherwise) and the
     RBF backward's kernels by the dtype of w (likewise), the
     FastKAN forward's term-split error in bf16 ulps, and at (256, 256)
     torch.matmul of a prebuilt bf16 basis by the weight (a yardstick of
     the product alone); then the forward and backward of the autograd
     Functions against the plain path; then every kernel at the
     search-space corners of the experiment scripts (`phase_corners`:
     spline order 1-4 and grid 1-16, 2-32 centers, 500 and 3,703
     features, GAT heads of 2-128 columns, 512 outputs; the layer forwards
     also at 1, 7, 40 and 512 outputs, the RBF and B-spline backwards at
     2,048, in output parts) against its plain version;
  4. whole step, small graph, per node path (gin/kan, gcn/kan,
     gcn/fastkan, gin/fastkan, gat/kan, gat/fastkan, gin/mlp, gcn/mlp,
     gat/mlp), at five search-space
     corners (STEP_CORNERS) and for the base-free FastKAN and the
     layernorm-free FastKANLayer: the kernel path (fused=True) and the plain
     path (fused=False) agree on logits and every parameter gradient; then
     each of the 15 graph paths (GraphClassifier gin/gcn/gat and
     GraphRegressor gin/gcn, each with mlp/kan/fastkan) on one batch of 16
     molecules, in f32 and bf16, against the same model's plain path on the
     CPU (`phase_small_graph_steps`);
  5. main paths: the bf16 train step of each of the nine node paths at
     full width on the arxiv-sized synthetic graph (169,343 nodes,
     1,166,243 edges), and of FastKAN([128, 64, 64, 40], num_grids=8,
     use_base_update=False) on its node rows, 2 warm-up + 10 timed steps
     each, with the launch counters set to 0 before and checked after each
     path, and a profiler breakdown (which keys the redesign order: device
     ms per step by kernel, summed over the paths); then each of the ten
     paths captured by `make_node_multi_step` (10 steps a CUDA graph, Adam
     capturable): its launches at the capture, none at a replay, ms/step
     captured against eager, peak memory, the losses bit for bit those of
     eager steps with the same Adam (whose first step runs under
     torch.cuda.set_sync_debug_mode("error")) and within 4 bf16 ulps of the
     default Adam's; then three drives of kernels no path launches, each forward
     and backward once with its counts checked the same way: the
     GIN+FastKAN fusion point `FastKAN(x, gin_graph=(g, 0))` (the GIN conv
     sums z itself for a FastKAN net, as the JAX model does), the
     layernorm-free FastKANLayer(128, 64) in bf16 (the RBF product of a
     bf16 basis) and the narrow segment sum (no caller, as in the JAX
     package); then the two graph paths at full width (`phase_graph_path`):
     G, bench.py's graph classification (gin/kan, 3 convs, batches of 256
     molecules from the native assembler) and R, the ZINC regression
     defaults (gin/kan, 4 GINE convs, OGB encoders, batches of 256 from
     batch_graphs), each through batch_loader(prefetch=2) and
     make_graph_*_steps: host assembly alone, a warm-up epoch, 2 timed
     epochs with the launches checked per step, graphs/s, peak memory, the
     busy share and top kernels over 3 profiled steps, and a prefetched
     epoch against the same batches moved synchronously; then
     `utils/profiling.kernel_report()` at its defaults;
  6. the protocol and data layer (`phase_protocol`), on data written in
     each format's raw layout into a temporary directory: (a) the
     arxiv-sized graph in ogbn-arxiv's layout (gzip CSVs, the time split)
     parsed by `load_ogbn_arxiv`, then `run_node_experiment` at the
     flagship widths (gin/kan, fused, bf16, rcm reorder, grids adapted
     every 2 epochs, 2 splits) with each split's ms per epoch, adaptation
     and reorder seconds, losses, accuracies and launches per epoch; the
     reordered graph's spmm and gin_fused against their f64 sums; a
     checkpoint resume (bit for bit); the card's least-squares solve
     against the CPU's gelsd; the B-spline kernels on adapted knots and on
     knots whose narrowest span bf16 rounds to zero (non-finite entries
     included); a sampled epoch (fanouts 10 and 5, 512 seeds) with the
     sampler's host ms beside the step's and the kernels on a sampled
     batch; then (b)-(d) the three experiment drivers' main() (Cora-shaped
     Planetoid pickles, gcn/fastkan; MUTAG in the TU layout, GAT/kan, 2
     folds; ZINC's subset pickles, GIN/FastKAN), 8 trials each, their logs
     in the JAX drivers' formats;
  7. distribution (`phase_dist`, kagnn_tpu_torch/dist/): (a) both halo
     entries of the fused GIN kernels (gin_kan_fused_halo,
     gin_fastkan_fused_halo) on shard 0 and an interior shard of the D=4
     halo plan of the arxiv-sized graph, fed an extended table directly, at
     the main path's widths in f32 and bf16, against their plain functions
     (forward, dz and the weight gradients with dw_walk_check, dx, dext
     against the f64 sender sum, twice bit for bit), timed beside the
     single-card entries; (b) the halo flagship step (gin/kan fused bf16,
     3 convs, 4 node shards) on 4 gloo ranks sharing cuda:0, 2 warm-up + 3
     timed steps, against the single-card step from the same weights:
     losses and logits within 4 bf16 ulps, gradients at the bf16 gradient
     bars, parameters equal on every rank, launches a step by kernel, ms a
     step and peak memory a rank (times of ranks sharing one card: the
     partition's cost, not scaling); the same step in f32 against the f32
     single-card step at the f32 step bars (values rtol 1e-4, gradients
     rtol 1e-3 / atol 1e-5); (c) the gin/fastkan halo fusion point
     and the gcn/kan and gat/kan halo steps at one conv in f32 against their
     single-card drives; (d) the edge-partitioned step (gcn/kan, 2 gloo
     ranks) and the DP graph-classification step (G's model, 2 gloo ranks,
     batches of 256 molecules) against their single-card counterparts;
     (e) one nccl rank: the halo flagship with force_full=True against the
     one-shard specialisation; the plan's boundary rows, rows exchanged and
     shard edges with and without rcm, what gloo does with tensors on the
     card, and the scaling driver's rows;
  8. prints the kernel list as one JSON line, then the result line.

It imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import ast
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np

# the card's peaks (bound_ms(bytes, operations, dtype)) and the CUDA-event
# timer, from the port; outside the repository this import fails first
from kagnn_tpu_torch.utils.profiling import (H100, kernel_base_name,
                                             kernel_row_of, time_ms)
from kagnn_tpu_torch.utils.time_gat import hub_row_alone, light_rows_alone
from kagnn_tpu_torch.utils.time_spmm_rbf import csr_matrix, spmm_cases
from kagnn_tpu_torch.kernels._common import GAT_PIECE, dw_tile
from kagnn_tpu_torch.kernels.selfcheck import (BF16_ULP, DW_CLOSE_TILES,
                                               GAT_SENDER_KERNELS,
                                               GAT_SPLIT_CASES,
                                               GIN_SPLIT_SHAPES,
                                               check_bspline_bwd,
                                               check_fastkan_bwd,
                                               check_gat_sender_split,
                                               check_gat_split,
                                               check_gin_fastkan_split,
                                               check_gin_split, check_narrow,
                                               dw_walk_check,
                                               gin_fastkan_expected,
                                               gin_fastkan_f64,
                                               gin_fused_expected,
                                               narrow_cases, narrow_f64,
                                               profiled_kernels,
                                               rbf_fwd_expected)

NODE_KW = dict(mp_layers=3, num_features=128, hidden_channels=64,
               num_classes=40, grid_size=4, spline_order=3, skip=False,
               hidden_layers=2, heads=4, dropout=0.0)  # bench.py _NODE_KW
# (D, O) of the layer kernels: GIN/GCN hidden (64, 64), head (64, 40), conv 0
# (128, 64); GAT transforms (128, 256) and (256, 256), GAT head (256, 40)
LAYER_SHAPES = ((64, 64), (64, 40), (128, 64), (128, 256), (256, 256), (256, 40))
GIN_FASTKAN_SHAPES = ((64, 64), (64, 40), (128, 64))


def log(*a):
    print(*a, flush=True)


def phase_device(torch):
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA device and found none")
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip()
    log(f"card: {card}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("tf32: matmul.allow_tf32=False cudnn.allow_tf32=False")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")
    return card


# (spline order, grid size) and centers of the search-space corners the
# corner phase runs (experiments/node_classification.py,
# graph_classification.py): each is a library of its own, built with the
# main paths' in one parallel build
KAN_CORNERS = ((1, 1), (2, 8), (4, 16), (1, 8))
FASTKAN_CORNERS = (2, 16, 32)
FWD_OUTPUTS = (1, 7, 40, 512)  # outputs the layer forwards mask or split
BSPLINE_WIDE_O = 2048  # outputs of the B-spline backward's corner in parts


def phase_build():
    from kagnn_tpu_torch.kernels import _build

    units = list(_build.MAIN)
    units += [(n, s) for n in ("bspline_fused", "gin_fused") for s in KAN_CORNERS]
    units += [(n, (g,)) for n in ("fastkan_layer", "gin_fastkan", "rbf_fused")
              for g in FASTKAN_CORNERS]
    units += [u for u in protocol_units() if u not in units]
    t0 = time.perf_counter()
    reports = _build.build_all(units)
    secs = time.perf_counter() - t0
    log(f"build: {len(units)} libraries of {len(_build.SOURCES)} sources in {secs:.1f} s")
    (_build.BUILD / "ptxas.txt").write_text(
        "\n".join(f"== {n}\n{r}" for n, r in reports.items()))
    for name, rep in reports.items():
        spills = [ln for ln in rep.splitlines()
                  if "spill" in ln and not ln.strip().endswith(
                      "0 bytes spill stores, 0 bytes spill loads")]
        log(f"ptxas {name}: {len(spills)} functions with spills")


def compare(torch, name, got, want, dtype):
    """Elementwise |got - want| <= c * max(|want|, mean |want|). f32:
    c = 1e-4, since the kernel and its plain version only sum in different
    orders; bf16: c = 4 bf16 ulps, since both round the same f32 sums to
    bf16 once and a flipped rounding costs one ulp on top of the order.
    The mean floors the scale of values near zero. Returns max |got -
    want|."""
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    err = diff.max().item()
    c = 1e-4 if dtype == "float32" else 4 * BF16_ULP
    scale = torch.clamp(want.abs(), min=max(want.abs().mean().item(), 1e-30))
    ratio = (diff / (c * scale)).max().item()
    ok = ratio <= 1.0 and math.isfinite(err)
    log(f"  {name} {dtype}: max_abs_err={err:.3e} worst err/tol={ratio:.3f} "
        f"(tol {c:.1e} x scale) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with its plain "
                             f"version: err/tol {ratio}")
    return err


def log_kernel_split(torch, name, fn, calls=5, row=None):
    """Device ms per call of each kernel fn() launches, from torch.profiler
    (`utils/profiling.device_profile`); the kernels of a call may overlap
    (the B-spline backward runs its dx kernel on a second stream). With
    `row`, fails unless each profiled kernel of the row's library (its
    name begins as the row's does: `gat` for gat_fwd) goes to that row of
    the kernel table. Returns the profiled kernels' base names (None when the
    profiler saw no device time)."""
    from kagnn_tpu_torch.utils.profiling import device_profile

    prof = device_profile(lambda: [fn() for _ in range(calls)], calls)
    if prof.ms is None:
        log(f"  {name} by kernel: not measured (the profiler saw no device time)")
        return None
    short = [key.replace("(anonymous namespace)::", "").replace("void ", "").split("(")[0]
             for key, _, _ in prof.kernels]
    log(f"  {name} by kernel, ms per call: " + ", ".join(
        f"{s} {t:.4f}" for s, (_, t, _) in zip(short, prof.kernels)))
    if row is not None:
        found = {kernel_row_of(key, {row: 1}) for key, _, _ in prof.kernels
                 if kernel_base_name(key).startswith(row.split("_")[0])}
        if found != {row}:
            raise AssertionError(f"{name}: profiled kernels went to rows {found}, "
                                 f"expected {row} alone")
    return {kernel_base_name(key) for key, _, _ in prof.kernels}


def log_resources(name, fn):
    """Log the registers a thread, shared memory a block and estimated
    occupancy of each kernel fn() launches, from the profiler's trace
    (`utils/profiling.launch_resources`)."""
    from kagnn_tpu_torch.utils.profiling import launch_resources

    res = launch_resources(fn)
    log(f"  {name} resources (registers, shared memory B, est. occupancy %): " + (
        ", ".join(f"{k} {v}" for k, v in sorted(res.items())) or "not recorded"))


def check_forward_kernel(torch, name, fn, want, calls=5):
    """Profile a layer forward (as many calls as log_kernel_split: a profile
    of one call read no device time on the H100 after a few): log the
    kernels it launched and fail unless it is `want` alone (in bf16 the
    tensor-core kernel; the CUDA-core one serves f32 only)."""
    from kagnn_tpu_torch.utils.profiling import device_profile, kernel_base_name

    prof = device_profile(lambda: [fn() for _ in range(calls)], calls)
    if prof.ms is None:
        log(f"  {name} kernel: not measured (the profiler saw no device time)")
        return
    names = sorted({kernel_base_name(key) for key, _, _ in prof.kernels})
    log(f"  {name} kernel: {', '.join(names)}")
    if names != [want]:
        raise AssertionError(f"{name}: launched {names}, expected {want} alone")


def bf16_ulps(torch, got, want):
    """max |got - want| in bf16 ulps of the output's scale: elementwise, the
    spacing of bf16 values (7 stored bits) at max(|want|, mean |want|). A
    flipped final rounding reads 1."""
    got, want = got.float(), want.float()
    scale = torch.clamp(want.abs(), min=max(want.abs().mean().item(), 1e-30))
    ulp = torch.exp2(torch.floor(torch.log2(scale)) - 7)
    return ((got - want).abs() / ulp).max().item()


def kernel_row(name, source, replaces):
    """One entry of the kernel list printed before the result line."""
    return dict(name=name, route="cuda", source=source, replaces=replaces,
                launches=0, max_abs_err=0.0, ms=None, plain_ms=None,
                bound_ms=None, bound_by=None, library_ms=None)


def record_row(r, err, main, **times):
    """Keep the worst error of every comparison; the times of the one
    comparison at the main path's representative shape."""
    r["max_abs_err"] = max(r["max_abs_err"], err)
    if main:
        r.update(times)


def matmul_yardstick(torch, name, basis, w):
    """Time torch.matmul of a prebuilt bf16 basis (N, NG*D) by the stacked
    weight (NG*D, O): the product alone at the tensor cores' library rate,
    without building the basis. A yardstick for the layer forward, not its
    library call (it skips the basis the kernel builds)."""
    ms = time_ms(lambda: torch.matmul(basis, w))
    n, k = basis.shape
    bms, by = H100.bound_ms((basis.numel() + w.numel() + n * w.shape[1]) * 2,
                            2 * n * k * w.shape[1], "bfloat16")
    log(f"  {name} yardstick: torch.matmul of a prebuilt bf16 basis ({n}, {k}) "
        f"by ({k}, {w.shape[1]}): ms={ms:.4f} bound_ms={bms:.4f} ({by})")


def log_gin_parts(torch, g, row, fn, ga, want, dn, D, O):
    """A fused GIN kernel (`row`: gin_fused or gin_fastkan, its wrapper fn
    with arguments ga = (x, senders, row_ptr, ...)) on the main graph: the
    kernels it launches for its dtype (`want`; the phase fails otherwise),
    each profiled kernel on its row of the kernel table, and the call's time
    over the receiver CSR's longest row alone and its light rows alone
    (every other row empty), with the split aggregate's kernels profiled
    there: its hub row is theirs alone."""
    x = ga[0]
    names = profiled_kernels(lambda: fn(*ga), want)
    log(f"  {row} main {dn} D={D} O={O} kernels: {', '.join(sorted(names))}")
    if names != want:
        raise AssertionError(f"{row} {dn}: launched {names}, expected {want}")
    log_kernel_split(torch, f"{row} main {dn} D={D} O={O}", lambda: fn(*ga), row=row)
    log_resources(f"{row} main {dn} D={D} O={O}", lambda: fn(*ga))
    hub_idx, hub_ptr, d_hub, hub = hub_row_alone(g)
    for part, (idx, rp) in ((f"hub row alone (node {hub}, in-degree {d_hub})",
                             (hub_idx, hub_ptr)),
                            ("light rows alone", light_rows_alone(g)[:2])):
        args = (x, idx, rp, *ga[3:])
        ms = time_ms(lambda: fn(*args))
        log(f"  {row} {part} {dn} D={D} O={O}: {ms:.4f} ms")
        log_kernel_split(torch, f"{row} {part} {dn} D={D} O={O}", lambda: fn(*args))


def phase_kernels(torch, big):
    """Each kernel against its plain version; `big` is the main path's graph."""
    from kagnn_tpu_torch.graphs import single_graph
    from kagnn_tpu_torch.kan.bspline import make_grid
    from kagnn_tpu_torch.kernels import bspline_fused as bf
    from kagnn_tpu_torch.kernels import gin_fused as gf
    from kagnn_tpu_torch.kernels import spmm

    rows = {
        "spmm": kernel_row("spmm", "kagnn_tpu_torch/csrc/spmm.cu",
                           "kagnn_tpu/pallas/spmm.py:88"),
        "bspline_fwd": kernel_row("bspline_fwd",
                                  "kagnn_tpu_torch/csrc/bspline_fused.cu",
                                  "kagnn_tpu/pallas/bspline_fused.py:66"),
        "bspline_bwd": kernel_row("bspline_bwd",
                                  "kagnn_tpu_torch/csrc/bspline_fused.cu",
                                  "kagnn_tpu/pallas/bspline_fused.py:86"),
        "gin_fused": kernel_row("gin_fused", "kagnn_tpu_torch/csrc/gin_fused.cu",
                                "kagnn_tpu/pallas/gin_fused.py:51"),
        "gcn_agg": kernel_row("gcn_agg", "kagnn_tpu_torch/csrc/gcn_agg.cu",
                              "kagnn_tpu/pallas/gcn_agg.py:49"),
        "fastkan_fwd": kernel_row("fastkan_fwd",
                                  "kagnn_tpu_torch/csrc/fastkan_layer.cu",
                                  "kagnn_tpu/pallas/fastkan_layer.py:48"),
        "fastkan_bwd": kernel_row("fastkan_bwd",
                                  "kagnn_tpu_torch/csrc/fastkan_layer.cu",
                                  "kagnn_tpu/pallas/fastkan_layer.py:62"),
        "gin_fastkan": kernel_row("gin_fastkan",
                                  "kagnn_tpu_torch/csrc/gin_fastkan.cu",
                                  "kagnn_tpu/pallas/gin_fastkan.py:42"),
        "gat_fwd": kernel_row("gat_fwd", "kagnn_tpu_torch/csrc/gat_fused.cu",
                              "kagnn_tpu/pallas/gat_fused.py:103"),
        "gat_dadst": kernel_row("gat_dadst", "kagnn_tpu_torch/csrc/gat_bwd.cu",
                                "kagnn_tpu/pallas/gat_bwd.py:138"),
        "gat_sender": kernel_row("gat_sender", "kagnn_tpu_torch/csrc/gat_bwd.cu",
                                 "kagnn_tpu/pallas/gat_bwd.py:282"),
        "rbf_fwd": kernel_row("rbf_fwd", "kagnn_tpu_torch/csrc/rbf_fused.cu",
                              "kagnn_tpu/pallas/rbf_fused.py:63"),
        "rbf_bwd": kernel_row("rbf_bwd", "kagnn_tpu_torch/csrc/rbf_fused.cu",
                              "kagnn_tpu/pallas/rbf_fused.py:73"),
        "spmm_narrow": kernel_row("spmm_narrow", "kagnn_tpu_torch/csrc/spmm_narrow.cu",
                                  "kagnn_tpu/pallas/spmm.py:311"),
    }
    gen = torch.Generator(device="cuda").manual_seed(0)
    rng = np.random.default_rng(0)
    small = single_graph(rng.integers(0, 100, 700), rng.integers(0, 100, 700),
                         n_node=100, device="cuda")
    k, grid_size = 3, 4

    def rand(shape, dtype, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * scale).to(dtype)

    def layer(D, O, dtype):
        knots = make_grid(D, grid_size, k, device="cuda").t().contiguous().to(dtype)
        wb = rand((D, O), dtype, 0.3)
        ws = rand(((grid_size + k) * D, O), dtype, 0.3)
        return knots, wb, ws

    def record(row, err, main, ms=None, plain_ms=None, bound_ms=None,
               bound_by=None, library_ms=None):
        record_row(rows[row], err, main, ms=ms, plain_ms=plain_ms,
                   bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms)

    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[1]
        s = torch.tensor([], dtype=dtype).element_size()
        for gname, g, timed in (("small", small, False), ("main", big, True)):
            N, E = g.n_node_pad, g.n_edge_pad
            # the main path's shapes: A^T dz over the sender CSR (D = 64)
            dz = rand((N, 64), dtype)
            args = (dz, g.send_row_ptr, g.receivers_by_sender)
            err = compare(torch, f"spmm {gname} ({N},64)",
                          spmm.sorted_segment_sum(*args),
                          spmm.sorted_segment_sum_plain(*args), dn)
            main = timed and dtype == torch.bfloat16
            if timed:
                ms = time_ms(lambda: spmm.sorted_segment_sum(*args))
                pms = time_ms(lambda: spmm.sorted_segment_sum_plain(*args))
                adj = torch.sparse_csr_tensor(
                    g.send_row_ptr.long(), g.receivers_by_sender.long(),
                    torch.ones(E, dtype=dtype, device="cuda"), size=(N, N),
                    check_invariants=False)
                lib = spmm.sorted_segment_sum_plain(*args)
                torch.testing.assert_close(torch.sparse.mm(adj, dz).float(),
                                           lib.float(), rtol=0.02, atol=0.1)
                lms = time_ms(lambda: torch.sparse.mm(adj, dz))
                bms, by = H100.bound_ms(2 * N * 64 * s + 4 * (E + N + 1),
                                        E * 64, dn)
                log(f"  spmm main {dn}: ms={ms:.4f} plain_ms={pms:.4f} "
                    f"library_ms={lms:.4f} bound_ms={bms:.4f} ({by})")
                record("spmm", err, main, ms, pms, bms, by, lms)
            else:
                record("spmm", err, False)

            # (64, 64): second update layers and the GIN backward of convs 1-2;
            # (64, 40): the head; (128, 64): the GIN backward of conv 0; the
            # GAT transforms (128, 256), (256, 256) and head (256, 40)
            for D, O in LAYER_SHAPES:
                knots, wb, ws = layer(D, O, dtype)
                x = rand((N, D), dtype)
                dout = rand((N, O), dtype, 0.1)
                fa = (x, knots, wb, ws, k)
                err = compare(torch, f"bspline_fwd {gname} D={D} O={O}",
                              bf.kan_linear_fwd(*fa), bf.kan_linear_fwd_plain(*fa), dn)
                errb = check_bspline_bwd(
                    f"bspline_bwd {gname} D={D} O={O}", *fa[:4], dout, k,
                    lambda name, a, b: compare(torch, name, a, b, dn),
                    wrong_must_fail=timed, log=log)
                nb1 = grid_size + k + 1
                if timed:
                    ms = time_ms(lambda: bf.kan_linear_fwd(*fa))
                    pms = time_ms(lambda: bf.kan_linear_fwd_plain(*fa))
                    bms, by = H100.bound_ms(
                        (N * D + knots.numel() + nb1 * D * O + N * O) * s,
                        2 * N * nb1 * D * O, dn)
                    log(f"  bspline_fwd main {dn} D={D} O={O}: ms={ms:.4f} "
                        f"plain_ms={pms:.4f} bound_ms={bms:.4f} ({by})")
                    check_forward_kernel(
                        torch, f"bspline_fwd main {dn} D={D} O={O}",
                        lambda: bf.kan_linear_fwd(*fa),
                        "bspline_fwd_mma_kernel" if main else "bspline_fwd_kernel")
                    if main and (D, O) == (256, 256):
                        matmul_yardstick(torch, "bspline_fwd", bf.dw_operand(x, knots, k),
                                         torch.cat([wb, ws]))
                    record("bspline_fwd", err, main and (D, O) == (64, 64), ms, pms, bms, by)
                    ms = time_ms(lambda: bf.kan_linear_bwd(*fa[:4], dout, k))
                    pms = time_ms(lambda: bf.kan_linear_bwd_plain(*fa[:4], dout, k))
                    bms, by = H100.bound_ms(
                        (2 * N * D + knots.numel() + 2 * nb1 * D * O + N * O) * s,
                        4 * N * nb1 * D * O, dn)
                    log(f"  bspline_bwd main {dn} D={D} O={O}: ms={ms:.4f} "
                        f"plain_ms={pms:.4f} bound_ms={bms:.4f} ({by})")
                    if main:
                        log_kernel_split(torch, f"bspline_bwd main {dn} D={D} O={O}",
                                         lambda: bf.kan_linear_bwd(*fa[:4], dout, k))
                        log_resources(f"bspline_bwd main {dn} D={D} O={O}",
                                      lambda: bf.kan_linear_bwd(*fa[:4], dout, k))
                    record("bspline_bwd", errb, main and (D, O) == (64, 64), ms, pms,
                           bms, by)
                else:
                    record("bspline_fwd", err, False)
                    record("bspline_bwd", errb, False)

            for D, O in ((128, 64), (64, 64)):
                knots, wb, ws = layer(D, O, dtype)
                x = rand((N, D), dtype)
                ga = (x, g.senders, g.recv_row_ptr, knots, wb, ws, k, 0.0)
                got, want = gf.gin_kan_fwd(*ga), gf.gin_kan_fwd_plain(*ga)
                nm = g.node_mask  # rows past the graph are unspecified
                err = max(compare(torch, f"gin_fused {gname} D={D} O={O} {w}",
                                  a[nm], b[nm], dn)
                          for w, a, b in zip(("out", "z"), got, want))
                if timed:
                    ms = time_ms(lambda: gf.gin_kan_fwd(*ga))
                    pms = time_ms(lambda: gf.gin_kan_fwd_plain(*ga))
                    nb1 = grid_size + k + 1
                    bms, by = H100.bound_ms(
                        (2 * N * D + knots.numel() + nb1 * D * O + N * O) * s
                        + 4 * (E + N + 1), E * D + 2 * N * nb1 * D * O, dn)
                    log(f"  gin_fused main {dn} D={D} O={O}: ms={ms:.4f} "
                        f"plain_ms={pms:.4f} bound_ms={bms:.4f} ({by})")
                    record("gin_fused", err, main and D == 64, ms, pms, bms, by)
                    log_gin_parts(torch, g, "gin_fused", gf.gin_kan_fwd, ga,
                                  gin_fused_expected(x), dn, D, O)
                else:
                    record("gin_fused", err, False)
    phase_spmm(torch, big, rows)
    phase_gin_split(torch, rows)
    phase_new_kernels(torch, big, rows)
    return rows


# spmm: widths of spmm_split_graph's checks (one column, odd widths, the
# head's 40, whole 16-byte packs at 64 and 128, several slabs at 300) and of
# the gin/fastkan step's sums of z over the receiver CSR (conv 0: 128, convs
# 1-2: 64)
SPMM_SPLIT_WIDTHS = (1, 7, 40, 42, 64, 128, 300)
SPMM_RECEIVER_WIDTHS = (128, 64)


def phase_spmm(torch, big, rows):
    """spmm on a graph whose both CSRs hold heavy rows (a 2,748-edge receiver
    row, rows of 63-65, a 316-edge sender row, the pad row heavy by its
    padding; `selfcheck.spmm_split_graph`), over both CSRs with their gather
    index and the receiver CSR without one, at SPMM_SPLIT_WIDTHS, twice and
    equal bit for bit; then over the main graph's receiver CSR with idx =
    senders at the gin/fastkan step's widths, against its plain function
    evaluated in f64 (`selfcheck.spmm_f64`: the plain version's atomics add
    the hub row's terms in a new order each run) and timed, beside
    torch.sparse.mm of a CSR of the same matrix (the library yardstick; the
    port never calls it) and its bound (msgs read once, out written once,
    idx and row_ptr read; E*D adds), and on that CSR's longest row alone and
    its light rows alone (`utils/time_spmm_rbf.spmm_cases`)."""
    from kagnn_tpu_torch.kernels import spmm
    from kagnn_tpu_torch.kernels.selfcheck import (check_spmm_split, spmm_f64,
                                                   spmm_split_graph)

    gen = torch.Generator(device="cuda").manual_seed(11)
    sg = spmm_split_graph()
    cases = spmm_cases(big)
    N, E = big.n_node_pad, big.n_edge_pad
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[1]
        s = torch.tensor([], dtype=dtype).element_size()
        for D in SPMM_SPLIT_WIDTHS:
            record_row(rows["spmm"], check_spmm_split(
                sg, D, dtype, lambda name, a, b: compare(torch, name, a, b, dn), gen), False)
        for D in SPMM_RECEIVER_WIDTHS:
            msgs = torch.randn((N, D), generator=gen, device="cuda").to(dtype)
            rp, idx = cases["receiver"]
            plain = spmm.sorted_segment_sum_plain(msgs, rp, idx)
            err = compare(torch, f"spmm receiver CSR main ({N},{D})",
                          spmm.sorted_segment_sum(msgs, rp, idx),
                          spmm_f64(msgs, rp, idx), dn)
            record_row(rows["spmm"], err, False)
            times = {}
            for case in ("receiver", "hub", "light"):
                args = (msgs, *cases[case])
                if case != "receiver":
                    compare(torch, f"spmm receiver CSR {case} ({N},{D})",
                            spmm.sorted_segment_sum(*args), spmm_f64(*args), dn)
                times[case] = time_ms(lambda: spmm.sorted_segment_sum(*args))
            pms = time_ms(lambda: spmm.sorted_segment_sum_plain(msgs, rp, idx), iters=5)
            a = csr_matrix(rp, idx, N, dtype)
            lib = torch.sparse.mm(a, msgs).float()
            lib_err = ((lib - plain.float()).abs().max() / plain.float().abs().max()).item()
            if dn == "float32":  # the bf16 CSR product rounds its sums to bf16
                torch.testing.assert_close(lib, plain, rtol=1e-4, atol=1e-3)
            lms = time_ms(lambda: torch.sparse.mm(a, msgs))
            bms, by = H100.bound_ms(2 * N * D * s + 4 * (E + N + 1), E * D, dn)
            ms = times["receiver"]
            log(f"  spmm receiver CSR main {dn} D={D}: ms={ms:.4f} plain_ms={pms:.4f} "
                f"library_ms={lms:.4f} (torch.sparse.mm, max error {lib_err:.2e} of "
                f"the scale) bound_ms={bms:.4f} ({by}); hub row alone "
                f"{times['hub']:.4f} ms, light rows alone {times['light']:.4f} ms; "
                f"{ms / lms:.2f}x the library's time")


# gin_fused: widths of check_gin_split (one value a lane, the main paths'
# 64 and 128, several column slabs at 300)
GIN_SPLIT_WIDTHS = (7, 64, 128, 300)


# gin_fastkan: centers of check_gin_fastkan_split (the main paths', the
# search space's most)
GIN_FASTKAN_SPLIT_G = (4, 32)


def phase_gin_split(torch, rows):
    """gin_fused and gin_fastkan on spmm_split_graph (a 2,748-edge receiver
    row, rows of 63-65, the pad row heavy by its padding), out and z of every
    row against their plain functions on the exactly summed z at
    GIN_SPLIT_WIDTHS and at GIN_SPLIT_SHAPES (gin_fused) or
    GIN_FASTKAN_SPLIT_G (gin_fastkan), in f32 and bf16, twice and equal bit
    for bit (`selfcheck.check_gin_split`, `check_gin_fastkan_split`)."""
    from kagnn_tpu_torch.kernels.selfcheck import spmm_split_graph

    gen = torch.Generator(device="cuda").manual_seed(12)
    sg = spmm_split_graph()
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[1]
        close = lambda name, a, b: compare(torch, name, a, b, dn)  # noqa: E731
        for D in GIN_SPLIT_WIDTHS:
            for shape in GIN_SPLIT_SHAPES:
                record_row(rows["gin_fused"], check_gin_split(
                    sg, D, 64, dtype, close, gen, shape), False)
            for G in GIN_FASTKAN_SPLIT_G:
                record_row(rows["gin_fastkan"], check_gin_fastkan_split(
                    sg, D, 64, dtype, close, gen, G), False)


def ragged_graph(torch):
    """301 nodes (N off every tile), isolated nodes, and node 0 with an
    in-degree of 301 (above 256: its degree rounds under bf16)."""
    from kagnn_tpu_torch.graphs import single_graph

    rng = np.random.default_rng(4)
    snd = np.concatenate([rng.integers(0, 301, 900), np.arange(301)])
    rcv = np.concatenate([rng.integers(0, 301, 900), np.zeros(301, np.int64)])
    g = single_graph(snd, rcv, n_node=301, device="cuda")
    deg = g.in_degrees[:g.n_node]
    assert int(deg.max()) > 256 and int((deg == 0).sum()) > 0
    return g


def csr_gcn_matrix(torch, g, dinv, dtype):
    """diag(dinv) (A + I) as a CSR matrix: row i holds dinv_i at the
    senders of its edges and at i itself (the library yardstick of
    gcn_agg; the port never builds it)."""
    from kagnn_tpu_torch.kernels._common import segment_ids

    N = g.n_node_pad
    ar = torch.arange(N, device="cuda")
    rows = torch.cat([segment_ids(g.recv_row_ptr), ar])
    cols = torch.cat([g.senders.long(), ar])
    order = torch.argsort(rows, stable=True)
    crow = g.recv_row_ptr.long() + torch.arange(N + 1, device="cuda")
    return torch.sparse_csr_tensor(crow, cols[order], dinv[rows[order]].to(dtype),
                                   size=(N, N), check_invariants=False)


def gcn_hub_alone(torch, g, hs, dinv, dn):
    """gcn_agg on a graph that keeps only the main graph's longest receiver
    row (every other row empty): the time of the hub row's pieces and their
    combine, a floor under the whole launch."""
    from kagnn_tpu_torch.graphs import single_graph
    from kagnn_tpu_torch.kernels import gcn_agg as ga
    from kagnn_tpu_torch.kernels.selfcheck import gcn_agg_f64

    deg = g.recv_row_ptr[1:] - g.recv_row_ptr[:-1]
    hub = int(deg[:g.n_node].argmax())
    e0, d_hub = int(g.recv_row_ptr[hub]), int(deg[hub])
    h = single_graph(g.senders[e0:e0 + d_hub].cpu().numpy(), np.full(d_hub, hub),
                     n_node=g.n_node, edge_pad_multiple=1024, device="cuda")
    args = (hs, dinv, h.senders, h.recv_row_ptr)
    compare(torch, "gcn_agg hub row alone", ga.gcn_agg_fwd(*args, h.receivers),
            gcn_agg_f64(*args), dn)
    ms = time_ms(lambda: ga.gcn_agg_fwd(*args, h.receivers))
    log(f"  gcn_agg hub row alone {dn} (node {hub}, in-degree {d_hub}): {ms:.4f} ms")


def phase_gcn_split(torch, rows):
    """gcn_agg against its plain function evaluated in f64 (`gcn_agg_f64`)
    on a hub row of 100,000 in-edges and on a graph of light rows, D 64
    (16-byte loads) and D 42 (rows not whole 16-byte packs: one value a
    lane), f32 and bf16, twice each and equal bit for bit (no atomics)."""
    from kagnn_tpu_torch.kernels import gcn_agg as ga
    from kagnn_tpu_torch.kernels.selfcheck import gcn_agg_f64, gcn_split_graph

    gen = torch.Generator(device="cuda").manual_seed(7)
    for kind, D in (("hub", 64), ("light", 64), ("hub", 42), ("light", 42)):
        g = gcn_split_graph(kind)
        for dtype in (torch.float32, torch.bfloat16):
            dn = str(dtype).split(".")[1]
            hs = torch.randn(g.n_node_pad, D, generator=gen, device="cuda").to(dtype)
            dinv = torch.rsqrt(g.in_degrees.float() + 1.0)
            args = (hs, dinv, g.senders, g.recv_row_ptr)
            got = ga.gcn_agg_fwd(*args, g.receivers)
            err = compare(torch, f"gcn_agg {kind} ({g.n_node_pad},{D})", got,
                          gcn_agg_f64(*args), dn)
            if not torch.equal(got, ga.gcn_agg_fwd(*args, g.receivers)):
                raise AssertionError(f"gcn_agg {kind} {dn}: two runs differ")
            record_row(rows["gcn_agg"], err, False)


def log_split_reading(torch, tag, got, want):
    """The bf16 FastKAN forward's error against its plain f32 product (both
    rounded to bf16 once), in bf16 ulps of the output's scale, and the share
    of outputs that differ: the kernel multiplies each f32 basis value as
    bf16 terms (`fastkan_common.cuh::kFwdTerms`), so a reading of 1 is a
    flipped final rounding."""
    ulps = bf16_ulps(torch, got, want)
    differ = (got != want).float().mean().item()
    log(f"  fastkan_fwd term split at {tag}: {ulps:.3f} bf16 ulps of the "
        f"output's scale, {differ:.2e} of the elements differ")


def phase_new_kernels(torch, big, rows):
    """gcn_agg, the FastKANLayer forward and backward and gin_fastkan
    against their plain versions (`big` is the main paths' graph)."""
    from kagnn_tpu_torch.graphs import single_graph
    from kagnn_tpu_torch.kernels import fastkan_layer as fk
    from kagnn_tpu_torch.kernels import gcn_agg as ga
    from kagnn_tpu_torch.kernels import gin_fastkan as gfk

    gen = torch.Generator(device="cuda").manual_seed(1)
    rng = np.random.default_rng(1)
    small = single_graph(rng.integers(0, 100, 700), rng.integers(0, 100, 700),
                         n_node=100, device="cuda")
    G = NODE_KW["grid_size"]

    def rand(shape, dtype, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * scale).to(dtype)

    def layer(D, O, dtype):
        """lng, lnb, w (G*D, O), wb (D, O), bb (O,) in the kernel layouts."""
        return (1.0 + rand((D,), dtype, 0.2), rand((D,), dtype, 0.1),
                rand((G * D, O), dtype, 0.3), rand((D, O), dtype, 0.3),
                rand((O,), dtype, 0.1))

    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[1]
        s = torch.tensor([], dtype=dtype).element_size()
        for gname, g in (("small", small), ("ragged", ragged_graph(torch)),
                         ("main", big)):
            N, E = g.n_node_pad, g.n_edge_pad
            timed = gname == "main"
            main = timed and dtype == torch.bfloat16
            nm = g.node_mask  # GIN rows past the graph are unspecified

            # gcn_agg at the main paths' width (hidden 64), dinv as the GCN
            # conv computes it (degrees in the compute dtype before the +1)
            hs = rand((N, 64), dtype)
            dinv = torch.rsqrt(g.in_degrees.to(dtype) + 1.0).float()
            args = (hs, dinv, g.senders, g.recv_row_ptr)
            err = compare(torch, f"gcn_agg {gname} ({N},64)",
                          ga.gcn_agg_fwd(*args, g.receivers), ga.gcn_agg_plain(*args), dn)
            times = {}
            if timed:
                ms = time_ms(lambda: ga.gcn_agg_fwd(*args, g.receivers))
                pms = time_ms(lambda: ga.gcn_agg_plain(*args))
                mat = csr_gcn_matrix(torch, g, dinv, dtype)
                torch.testing.assert_close(torch.sparse.mm(mat, hs).float(),
                                           ga.gcn_agg_plain(*args).float(),
                                           rtol=0.02, atol=0.1)
                lms = time_ms(lambda: torch.sparse.mm(mat, hs))
                bms, by = H100.bound_ms(2 * N * 64 * s + 4 * (N + E + N + 1),
                                        E * 64 + 2 * N * 64, dn)
                log(f"  gcn_agg main {dn}: ms={ms:.4f} plain_ms={pms:.4f} "
                    f"library_ms={lms:.4f} bound_ms={bms:.4f} ({by})")
                times = dict(ms=ms, plain_ms=pms, bound_ms=bms, bound_by=by,
                             library_ms=lms)
                gcn_hub_alone(torch, g, hs, dinv, dn)
            record_row(rows["gcn_agg"], err, main, **times)

            # (64, 64): hidden layers; (64, 40): the head; (128, 64): conv 0;
            # then the GAT transforms and head (the layer kernels only)
            for D, O in LAYER_SHAPES:
                gin = (D, O) in GIN_FASTKAN_SHAPES
                lw = layer(D, O, dtype)
                x = rand((N, D), dtype)
                x[N - 1] = 0.0  # a row of zeros, as pad rows after BatchNorm
                dout = rand((N, O), dtype, 0.1)
                fa = (x, *lw, -2.0, 2.0)
                ba = (x, *lw[:4], dout, -2.0, 2.0)
                err = compare(torch, f"fastkan_fwd {gname} D={D} O={O}",
                              fk.fastkan_layer_fwd(*fa),
                              fk.fastkan_layer_fwd_plain(*fa), dn)
                errb = check_fastkan_bwd(
                    f"fastkan_bwd {gname} D={D} O={O}", x, *lw[:4], dout,
                    lambda name, a, b: compare(torch, name, a, b, dn),
                    wrong_must_fail=timed, log=log)
                ga_args = (x, g.senders, g.recv_row_ptr, *lw, 0.0, -2.0, 2.0)
                # against the plain function on the exactly summed z (the
                # plain version's atomics add node 0's 2,748 terms in a new
                # order each run)
                errg = max((compare(torch, f"gin_fastkan {gname} D={D} O={O} {w}",
                                    a[nm], b[nm], dn)
                            for w, a, b in zip(("out", "z"),
                                               gfk.gin_fastkan_fwd(*ga_args),
                                               gin_fastkan_f64(*ga_args[:-2]))),
                           default=0.0) if gin else 0.0
                rep = main and (D, O) == (64, 64)
                if not timed:
                    for name, e in (("fastkan_fwd", err), ("fastkan_bwd", errb),
                                    ("gin_fastkan", errg)):
                        record_row(rows[name], e, False)
                    continue
                wbytes = (2 * D + G * D * O + D * O + O) * s
                prods = 2 * N * (G + 1) * D * O
                for name, e, fn, plain, nbytes, ops in (
                        ("fastkan_fwd", err,
                         lambda: fk.fastkan_layer_fwd(*fa),
                         lambda: fk.fastkan_layer_fwd_plain(*fa),
                         (N * D + N * O) * s + wbytes, prods),
                        ("fastkan_bwd", errb,
                         lambda: fk.fastkan_layer_bwd(*ba),
                         lambda: fk.fastkan_layer_bwd_plain(*ba),
                         (2 * N * D + N * O) * s + 2 * wbytes, 2 * prods),
                        ("gin_fastkan", errg,
                         lambda: gfk.gin_fastkan_fwd(*ga_args),
                         lambda: gfk.gin_fastkan_fwd_plain(*ga_args),
                         (2 * N * D + N * O) * s + wbytes + 4 * (E + N + 1),
                         E * D + prods)):
                    if name == "gin_fastkan" and not gin:
                        continue
                    ms = time_ms(fn)
                    pms = time_ms(plain, iters=5)
                    bms, by = H100.bound_ms(nbytes, ops, dn)
                    log(f"  {name} main {dn} D={D} O={O}: ms={ms:.4f} "
                        f"plain_ms={pms:.4f} bound_ms={bms:.4f} ({by})")
                    if name == "fastkan_fwd":
                        check_forward_kernel(
                            torch, f"fastkan_fwd main {dn} D={D} O={O}", fn,
                            "fastkan_fwd_mma_kernel" if main else "fastkan_fwd_kernel")
                    if name == "fastkan_fwd" and main and (D, O) == (256, 256):
                        log_split_reading(torch, f"D={D} O={O}", fn(), plain())
                        xs = x.float()
                        xhat, _ = fk.layer_norm_f32(xs)
                        basis, _ = fk.wide_basis(
                            xhat * lw[0].float() + lw[1].float(),
                            torch.from_numpy(fk.centers(-2.0, 2.0, G)).cuda(),
                            fk.inv_h(-2.0, 2.0, G))
                        matmul_yardstick(
                            torch, "fastkan_fwd",
                            torch.cat([xs * torch.sigmoid(xs), basis], 1).to(dtype),
                            torch.cat([lw[3], lw[2]]))
                    if name == "fastkan_bwd" and main:
                        log_kernel_split(torch, f"fastkan_bwd main {dn} D={D} O={O}", fn)
                    if name == "gin_fastkan" and O == 64:
                        log_gin_parts(torch, g, "gin_fastkan", gfk.gin_fastkan_fwd, ga_args,
                                      gin_fastkan_expected(x), dn, D, O)
                    record_row(rows[name], e, rep, ms=ms, plain_ms=pms,
                               bound_ms=bms, bound_by=by)
    phase_gcn_split(torch, rows)
    phase_gat_kernels(torch, big, rows)
    phase_rbf_narrow_kernels(torch, big, rows)
    phase_autograd_functions(torch)


def phase_gat_kernels(torch, big, rows):
    """The three GAT kernels against their plain versions at the main
    paths' heads and width (H 4, C 64), f32 and bf16, on a small graph, the
    ragged one and the main paths' graph (`big`), timed on the latter.
    Bytes of the bound: h and dout read once, out or dh written once, the
    (N, H) f32 arrays, and the indices of the valid edges; operations: the
    products of the valid edges. No PyTorch call computes GAT attention, so
    there is no library time. On the main graph also: gat_fwd and gat_dadst
    on its hub row alone and on its light rows alone (timed); gat_sender
    over its receiver CSR walked as a sender CSR (node 0 sending 2,748
    edges), whole, that row alone and the light rows alone (timed), and the
    kernels it launches (the phase fails unless they are its two); and the
    three kernels' launches profiled, each kernel on its own row of the
    kernel table (the phase fails otherwise). Then the split kernels on the
    graphs of `selfcheck.gat_split_case` (rows of 63-65 edges, two heavy rows
    in one chunk, n_edge cut inside a heavy row, a 2,748-edge hub row) and,
    for gat_sender, of `gat_sender_split_case` (the same edges reversed),
    twice each and equal bit for bit."""
    from kagnn_tpu_torch.graphs import single_graph
    from kagnn_tpu_torch.kernels import gat_bwd as gbw
    from kagnn_tpu_torch.kernels import gat_fused as gfu

    gen = torch.Generator(device="cuda").manual_seed(2)
    rng = np.random.default_rng(2)
    small = single_graph(rng.integers(0, 100, 700), rng.integers(0, 90, 700),
                         n_node=100, device="cuda")
    H, C = NODE_KW["heads"], NODE_KW["hidden_channels"]
    slope = 0.2

    def rand(shape, dtype, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * scale).to(dtype)

    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[1]
        s = torch.tensor([], dtype=dtype).element_size()
        for gname, g in (("small", small), ("ragged", ragged_graph(torch)),
                         ("main", big)):
            N, nv = g.n_node_pad, g.n_edge
            h = rand((N, H * C), dtype)
            asrc, adst = rand((N, H), torch.float32, 2.0), rand((N, H), torch.float32, 2.0)
            dout = rand((N, H * C), dtype, 0.1)
            fa = (h, asrc, adst, g.senders, g.recv_row_ptr, nv, slope)
            out, alpha = gfu.gat_fwd(*fa)
            want = gfu.gat_fwd_plain(*fa)
            err = max(compare(torch, f"gat_fwd {gname} out", out, want[0], dn),
                      compare(torch, f"gat_fwd {gname} alpha", alpha, want[1],
                              "float32"))
            S = (dout * out).float().reshape(N, H, C).sum(2).contiguous()
            da = (h, asrc, adst, alpha, S, dout, g.senders, g.recv_row_ptr, nv,
                  slope)
            errd = compare(torch, f"gat_dadst {gname}", gbw.gat_dadst(*da),
                           gbw.gat_dadst_plain(*da), "float32")
            sa = (*da[:6], g.receivers_by_sender, g.send_row_ptr, nv, slope)
            errs = max(compare(torch, f"gat_sender {gname} {w}", a, b, "float32")
                       for w, a, b in zip(("dh", "dasrc"), gbw.gat_sender(*sa),
                                          gbw.gat_sender_plain(*sa)))
            main = gname == "main" and dtype == torch.bfloat16
            if gname != "main":
                for name, e in (("gat_fwd", err), ("gat_dadst", errd),
                                ("gat_sender", errs)):
                    record_row(rows[name], e, False)
                continue
            wide, narrow = N * H * C * s, 4 * N * H
            idx = 4 * nv + 4 * (N + 1)
            ops = 2 * nv * H * C
            for name, e, fn, plain, nbytes, n_ops in (
                    ("gat_fwd", err, lambda: gfu.gat_fwd(*fa),
                     lambda: gfu.gat_fwd_plain(*fa),
                     2 * wide + 3 * narrow + idx, ops),
                    ("gat_dadst", errd, lambda: gbw.gat_dadst(*da),
                     lambda: gbw.gat_dadst_plain(*da),
                     2 * wide + 5 * narrow + idx, ops),
                    ("gat_sender", errs, lambda: gbw.gat_sender(*sa),
                     lambda: gbw.gat_sender_plain(*sa),
                     2 * wide + 4 * N * H * C + 5 * narrow + idx, 2 * ops)):
                ms = time_ms(fn)
                pms = time_ms(plain, iters=5)
                bms, by = H100.bound_ms(nbytes, n_ops, dn)
                log(f"  {name} main {dn} H={H} C={C}: ms={ms:.4f} "
                    f"plain_ms={pms:.4f} bound_ms={bms:.4f} ({by}) library_ms=none")
                record_row(rows[name], e, main, ms=ms, plain_ms=pms,
                           bound_ms=bms, bound_by=by, library_ms=None)
            # the longest receiver row alone (every other row empty; its
            # pieces and combine), and the light rows alone (the heavy
            # rows' edges dropped): the two parts of the launches above
            snd, rp, d_hub, hub = hub_row_alone(g)
            for part, (ps, prp, pn) in (
                    (f"hub row alone (node {hub}, in-degree {d_hub})", (snd, rp, d_hub)),
                    ("light rows alone", light_rows_alone(g))):
                t_fwd = time_ms(lambda: gfu.gat_fwd(h, asrc, adst, ps, prp, pn, slope))
                t_dadst = time_ms(lambda: gbw.gat_dadst(
                    h, asrc, adst, alpha, S, dout, ps, prp, pn, slope))
                log(f"  GAT {part} {dn} ({pn} edges): gat_fwd {t_fwd:.4f} ms, "
                    f"gat_dadst {t_dadst:.4f} ms")
            # gat_sender over the receiver CSR walked as a sender CSR (node
            # 0 then sends 2,748 edges, as where edges run both ways):
            # whole, its longest row alone and its light rows alone
            for part, (ps, prp, pn) in (
                    ("receiver CSR as senders", (g.senders, g.recv_row_ptr, nv)),
                    (f"its hub row alone (node {hub}, {d_hub} edges)", (snd, rp, d_hub)),
                    ("its light rows alone", light_rows_alone(g))):
                t_snd = time_ms(lambda: gbw.gat_sender(
                    h, asrc, adst, alpha, S, dout, ps, prp, pn, slope))
                log(f"  gat_sender {part} {dn} ({pn} edges): {t_snd:.4f} ms")
            names = profiled_kernels(lambda: gbw.gat_sender(*sa), GAT_SENDER_KERNELS)
            if names != GAT_SENDER_KERNELS:
                raise AssertionError(f"gat_sender {dn}: launched {names}")
            # each launch of the three split kernels, profiled, must find its
            # row of the kernel table (the redesign order reads it)
            for name, fn in (("gat_fwd", lambda: gfu.gat_fwd(*fa)),
                             ("gat_dadst", lambda: gbw.gat_dadst(*da)),
                             ("gat_sender", lambda: gbw.gat_sender(*sa))):
                log_kernel_split(torch, f"{name} main {dn}", fn, row=name)
    gen = torch.Generator(device="cuda").manual_seed(3)
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[1]
        for kind in GAT_SPLIT_CASES:
            errs = check_gat_split(
                kind, H, C, dtype,
                lambda name, a, b, k: compare(torch, name, a, b, "float32" if k else dn),
                gen)
            for name, err in zip(("gat_fwd", "gat_dadst"), errs):
                record_row(rows[name], err, False)
            record_row(rows["gat_sender"], check_gat_sender_split(
                kind, H, C, dtype, lambda name, a, b: compare(torch, name, a, b, "float32"),
                gen), False)


# (D, O) of the RBF kernels on the base-free FastKAN([128, 64, 64, 40]) and
# the layernorm-free layer: conv-0 width (128, 64), hidden (64, 64), head
# (64, 40); x/w dtypes: f32/f32 (no compute dtype), f32/bf16 (layernorm on
# under bf16: the main path), bf16/bf16 (layernorm off under bf16)
RBF_SHAPES = ((128, 64), (64, 64), (64, 40))
RBF_DTYPES = (("float32", "float32"), ("float32", "bfloat16"),
              ("bfloat16", "bfloat16"))
RBF_G = 8


def phase_rbf_narrow_kernels(torch, big, rows):
    """The RBF forward and backward on 100 rows, 301 rows and the main
    graph's 169,344 rows, and the narrow segment sum over small, ragged and
    the main graph's (`big`) receivers, against their plain versions, timed
    at the main shapes. RBF bound: x, w and dout read
    once, out or dx and dW written once; operations the products, at the bf16
    peak when x and w are bf16, else at the f32 one; no PyTorch call computes
    it. Narrow bound: vals and receivers read, out written; the library call
    is torch.sparse.mm of a CSR of ones (N x E) with vals."""
    from kagnn_tpu_torch.kernels import rbf_fused as rf
    from kagnn_tpu_torch.kernels import spmm

    gen = torch.Generator(device="cuda").manual_seed(3)
    ragged = ragged_graph(torch)

    def rand(shape, dtype, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * scale).to(dtype)

    for xn, wn in RBF_DTYPES:
        xd, wd = getattr(torch, xn), getattr(torch, wn)
        sx, sw = (torch.tensor([], dtype=t).element_size() for t in (xd, wd))
        prod = "bfloat16" if xd == wd == torch.bfloat16 else "float32"
        for gname, N in (("small", 100), ("ragged", 301), ("main", big.n_node_pad)):
            timed = gname == "main"
            for D, O in RBF_SHAPES:
                x = rand((N, D), xd, 1.5)
                w = rand((RBF_G * D, O), wd, 0.3)
                dout = rand((N, O), xd)
                fa, ba = (x, w, -2.0, 2.0), (x, w, dout, -2.0, 2.0)
                # each output held at the tolerance of its own dtype
                err = compare(torch, f"rbf_fwd {gname} {xn}/{wn} D={D} O={O}",
                              rf.rbf_spline_fwd(*fa), rf.rbf_spline_fwd_plain(*fa),
                              xn)
                (dx, dw), (pdx, pdw) = rf.rbf_spline_bwd(*ba), rf.rbf_spline_bwd_plain(*ba)
                bname = f"rbf_bwd {gname} {xn}/{wn} D={D} O={O}"
                errb = compare(torch, f"{bname} dx", dx, pdx, xn)
                if wn == "bfloat16" and -(-N // dw_tile(N)) > DW_CLOSE_TILES:
                    c, ih = rf.constants(-2.0, 2.0, RBF_G, x.dtype)
                    basis, _ = rf.basis_plain(x, c, ih, round_exp=False)
                    errb = max(errb, dw_walk_check(f"{bname} dw", basis, dout,
                                                   dw_tile(N), dw, pdw, timed, log))
                    del basis
                else:
                    errb = max(errb, compare(torch, f"{bname} dw", dw, pdw, wn))
                del dx, dw, pdx, pdw
                rep = timed and (xn, wn, D, O) == ("float32", "bfloat16", 64, 64)
                if not timed:
                    record_row(rows["rbf_fwd"], err, False)
                    record_row(rows["rbf_bwd"], errb, False)
                    continue
                ops = 2 * N * RBF_G * D * O
                wbytes = RBF_G * D * O * sw
                for name, e, fn, plain, nbytes, n_ops in (
                        ("rbf_fwd", err, lambda: rf.rbf_spline_fwd(*fa),
                         lambda: rf.rbf_spline_fwd_plain(*fa),
                         (N * D + N * O) * sx + wbytes, ops),
                        ("rbf_bwd", errb, lambda: rf.rbf_spline_bwd(*ba),
                         lambda: rf.rbf_spline_bwd_plain(*ba),
                         (2 * N * D + N * O) * sx + 2 * wbytes, 2 * ops)):
                    ms = time_ms(fn)
                    pms = time_ms(plain, iters=5)
                    bms, by = H100.bound_ms(nbytes, n_ops, prod)
                    log(f"  {name} main {xn}/{wn} D={D} O={O}: ms={ms:.4f} "
                        f"plain_ms={pms:.4f} bound_ms={bms:.4f} ({by}) "
                        f"library_ms=none")
                    if name == "rbf_fwd":
                        check_rbf_fwd_route(torch, f"rbf_fwd main {xn}/{wn} D={D} O={O}",
                                            fn, x, w, ops)
                    if name == "rbf_bwd":
                        check_rbf_bwd_route(torch, f"rbf_bwd main {xn}/{wn} D={D} O={O}",
                                            x, w, dout, ops)
                    record_row(rows[name], e, rep, ms=ms, plain_ms=pms,
                               bound_ms=bms, bound_by=by, library_ms=None)

    # the narrow sum: k = 4 over the main graph's receivers (a 4-head GAT's
    # per-edge quantities), and k in 1..8 on the small and ragged graphs and
    # the split's cases; its row pointer against torch.searchsorted exactly
    rng = np.random.default_rng(3)
    small_rcv = torch.from_numpy(np.sort(rng.integers(0, 110, 700)).astype(
        np.int32)).to("cuda")  # 10 past the 100 segments
    for dn in ("float32", "bfloat16"):
        dt = getattr(torch, dn)
        for case, (rcv, segs) in narrow_cases().items():
            for k in (1, 4, 8):
                vals = rand((rcv.numel(), k), dt, 10.0)
                record_row(rows["spmm_narrow"], check_narrow(
                    vals, rcv, segs, lambda got, want: compare(
                        torch, f"spmm_narrow split {case} k={k}", got, want, dn)), False)
        for gname, rcv, segs, ks in (
                ("small", small_rcv, 100, (1, 4, 8)),
                ("ragged", ragged.receivers, 301, (1, 4, 8)),
                ("main", big.receivers, big.n_node_pad, (4,))):
            E = rcv.numel()
            for k in ks:
                vals = rand((E, k), dt, 10.0)
                args = (vals, rcv, segs)
                err = compare(torch, f"spmm_narrow {gname} k={k}",
                              spmm.sorted_segment_sum_narrow(*args),
                              spmm.sorted_segment_sum_narrow_plain(*args), dn)
                if gname != "main":
                    record_row(rows["spmm_narrow"], err, False)
                    continue
                # the hub row (node 0's 2,748 edges) and the rest against the
                # function summed in f64; the row pointer exactly
                err = max(err, check_narrow(vals, rcv, segs, lambda got, want: compare(
                    torch, f"spmm_narrow main k={k} against f64", got, want, dn)))
                hub = int((rcv == 0).sum())
                err = max(err, compare(
                    torch, f"spmm_narrow main hub row ({hub} edges) against f64",
                    spmm.sorted_segment_sum_narrow(*args)[:1],
                    narrow_f64(vals, rcv, segs)[:1], dn))
                ms = time_ms(lambda: spmm.sorted_segment_sum_narrow(*args))
                ptr_ms = time_ms(lambda: spmm.narrow_row_ptr(rcv, segs))
                pms = time_ms(lambda: spmm.sorted_segment_sum_narrow_plain(*args))
                lms = None
                if dn == "float32":  # the bf16 CSR product sums in bf16
                    ones = torch.sparse_csr_tensor(
                        spmm.narrow_row_ptr(rcv, segs).long(),
                        torch.arange(E, device="cuda"),
                        torch.ones(E, dtype=dt, device="cuda"), size=(segs, E),
                        check_invariants=False)
                    torch.testing.assert_close(
                        torch.sparse.mm(ones, vals),
                        spmm.sorted_segment_sum_narrow_plain(*args),
                        rtol=1e-4, atol=1e-3)
                    lms = time_ms(lambda: torch.sparse.mm(ones, vals))
                s = torch.tensor([], dtype=dt).element_size()
                bms, by = H100.bound_ms((E * k + segs * k) * s + 4 * E, E * k, dn)
                log(f"  spmm_narrow main {dn} k={k}: ms={ms:.4f} (row pointer alone "
                    f"{ptr_ms:.4f}) plain_ms={pms:.4f} "
                    f"library_ms={'none' if lms is None else f'{lms:.4f}'} "
                    f"bound_ms={bms:.4f} ({by})")
                log_kernel_split(torch, f"spmm_narrow main {dn} k={k}",
                                 lambda: spmm.sorted_segment_sum_narrow(*args))
                record_row(rows["spmm_narrow"], err, dn == "float32", ms=ms,
                           plain_ms=pms, bound_ms=bms, bound_by=by,
                           library_ms=lms)


def check_rbf_fwd_route(torch, name, fn, x, w, ops):
    """Fail unless the RBF forward fn() launched the kernel of w's dtype
    (`selfcheck.rbf_fwd_expected`: the tensor-core kernel where w is bf16,
    the CUDA-core one where it is f32); where w is bf16, log the bound of
    the design's own work: its bf16 products (`rbf_fused.fwd_terms`: three
    of an f32 basis, one of a bf16 x's; `ops` = 2*N*G*D*O a product) at the
    tensor cores' peak."""
    from kagnn_tpu_torch.kernels import rbf_fused as rf

    (want,) = rbf_fwd_expected(w)
    check_forward_kernel(torch, name, fn, want)
    log_resources(name, fn)
    if w.dtype == torch.bfloat16:
        terms = rf.fwd_terms(x.dtype)
        tc_ms, _ = H100.bound_ms(0, terms * ops, "bfloat16")
        log(f"  {name} design: {terms} bf16 products of {ops / 1e9:.2f} GFLOP each, "
            f"{tc_ms:.4f} ms at the bf16 peak")


def check_rbf_bwd_route(torch, name, x, w, dout, ops):
    """Log the RBF backward's time by kernel and fail unless it launched the
    kernels of its dtypes (`selfcheck.rbf_bwd_expected`: the tensor-core
    kernels where w is bf16, the CUDA-core ones where it is f32); where w
    is bf16, also the bound of the design's own work: its bf16 products (dx:
    three terms of an f32 dout, one of a bf16 one; dW: six products of an
    f32 dout, three of a bf16 one; `ops` = 2*N*G*D*O a product) at the
    tensor cores' peak."""
    from kagnn_tpu_torch.kernels import rbf_fused as rf
    from kagnn_tpu_torch.kernels.selfcheck import rbf_bwd_expected, rbf_bwd_kernels

    fn = lambda: rf.rbf_spline_bwd(x, w, dout, -2.0, 2.0)  # noqa: E731
    (n, D), O = x.shape, w.shape[1]
    parts = rf._bwd_plan(n, D, O, w.shape[0] // D, rf.dtype_code(x), rf.dtype_code(w))
    want = rbf_bwd_expected(x, w, parts)
    names = log_kernel_split(torch, name, fn)
    if names != want:  # profiled again where events went missing
        names = rbf_bwd_kernels(x, w, dout, want)
    if not names:
        log(f"  {name} kernels: not measured (the profiler saw no device time)")
        return
    log(f"  {name} kernels: {', '.join(sorted(names))}")
    if names != want:
        raise AssertionError(f"{name}: launched {sorted(names)}, expected {sorted(want)}")
    if w.dtype == torch.bfloat16:
        f32 = x.dtype == torch.float32
        products = (3 if f32 else 1) + (6 if f32 else 3)
        tc_ms, _ = H100.bound_ms(0, products * ops, "bfloat16")
        log(f"  {name} design: {products} bf16 products of {ops / 1e9:.2f} GFLOP "
            f"each, {tc_ms:.4f} ms at the bf16 peak")


# (heads, columns a head) of the GAT corner: hidden 2, 37, 96 and 128 with
# the experiment scripts' 4 heads (H*C up to 512), and one head of 37
GAT_CORNERS = ((4, 2), (4, 37), (4, 96), (4, 128), (1, 37))


def phase_corners(torch, rows):
    """Every kernel at the search-space corners of the experiment scripts
    against its plain version, f32 and bf16, on the ragged graph (301
    nodes, a node of in-degree 301, isolated nodes): the B-spline
    forward, both backwards and gin_fused at spline order 1-4 and grid 1-16
    (KAN_CORNERS), with the bf16 backward also at 512 outputs; the FastKAN
    layer forward and backward, gin_fastkan and the RBF product at 2, 16
    and 32 centers and at 500 features, and with 32 centers at 3,703
    features (CiteSeer's width) and at 512 outputs (the dx kernels' output
    parts), the RBF backward also at 2,048 outputs with 2 and 32 centers
    (several output parts of dx); the three GAT kernels at GAT_CORNERS.
    Errors join each kernel's row; no time is taken."""
    from kagnn_tpu_torch.kan.bspline import make_grid
    from kagnn_tpu_torch.kernels import bspline_fused as bf
    from kagnn_tpu_torch.kernels import fastkan_layer as fk
    from kagnn_tpu_torch.kernels import gat_bwd as gbw
    from kagnn_tpu_torch.kernels import gat_fused as gfu
    from kagnn_tpu_torch.kernels import gin_fastkan as gfk
    from kagnn_tpu_torch.kernels import gin_fused as gf
    from kagnn_tpu_torch.kernels import rbf_fused as rf

    gen = torch.Generator(device="cuda").manual_seed(6)
    g = ragged_graph(torch)
    N, nm = g.n_node_pad, g.node_mask

    def rand(shape, dtype, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * scale).to(dtype)

    n_cmp = 0
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[1]

        def cmp(row, name, a, b, kind=dn):
            nonlocal n_cmp
            n_cmp += 1
            record_row(rows[row], compare(torch, name, a, b, kind), False)

        def cmp_bwd(row, err):
            nonlocal n_cmp
            n_cmp += 1
            record_row(rows[row], err, False)

        close = lambda name, a, b: compare(torch, name, a, b, dn)  # noqa: E731
        shapes = [(k, gs, D, O) for k, gs in KAN_CORNERS for D, O in ((40, 100), (64, 64))]
        if dtype == torch.bfloat16:  # the backward's output pieces
            shapes += [(4, 16, 32, 512), (3, 4, 64, 512)]
        # 2,048 outputs: the backward's dx kernels take them in parts
        # (bspline_fused.bwd_parts), except f32 at (4, 16), which fits whole
        shapes += [(3, 4, 40, BSPLINE_WIDE_O), (4, 16, 40, BSPLINE_WIDE_O)]
        for k, gs, D, O in shapes:
            knots = make_grid(D, gs, k, device="cuda").t().contiguous().to(dtype)
            wb, ws = rand((D, O), dtype, 0.3), rand(((gs + k) * D, O), dtype, 0.3)
            x, dout = rand((N, D), dtype), rand((N, O), dtype, 0.1)
            tag = f"order {k} grid {gs} D={D} O={O}"
            fa = (x, knots, wb, ws, k)
            cmp("bspline_fwd", f"bspline_fwd corner {tag}", bf.kan_linear_fwd(*fa),
                bf.kan_linear_fwd_plain(*fa))
            cmp_bwd("bspline_bwd", check_bspline_bwd(f"bspline_bwd corner {tag}", *fa[:4],
                                                     dout, k, close, log=log))
            if O == BSPLINE_WIDE_O:
                log_resources(f"bspline_bwd corner {tag} {dn}",
                              lambda: bf.kan_linear_bwd(*fa[:4], dout, k))
            ga = (x, g.senders, g.recv_row_ptr, knots, wb, ws, k, 0.25)
            for w, a, b in zip(("out", "z"), gf.gin_kan_fwd(*ga), gf.gin_kan_fwd_plain(*ga)):
                cmp("gin_fused", f"gin_fused corner {tag} {w}", a[nm], b[nm])
        for G, D, O in [(G, D, O) for G in FASTKAN_CORNERS for D, O in ((40, 100), (500, 64))] \
                + [(32, 3703, 64), (32, 64, 512)]:
            lw = (1.0 + rand((D,), dtype, 0.2), rand((D,), dtype, 0.1),
                  rand((G * D, O), dtype, 0.3), rand((D, O), dtype, 0.3), rand((O,), dtype, 0.1))
            x, dout = rand((N, D), dtype), rand((N, O), dtype, 0.1)
            x[N - 1] = 0.0
            tag = f"G={G} D={D} O={O}"
            got = fk.fastkan_layer_fwd(x, *lw, -2.0, 2.0)
            want = fk.fastkan_layer_fwd_plain(x, *lw, -2.0, 2.0)
            cmp("fastkan_fwd", f"fastkan_fwd corner {tag}", got, want)
            if dtype == torch.bfloat16 and (G, D) == (32, 500):
                log_split_reading(torch, tag, got, want)
            cmp_bwd("fastkan_bwd", check_fastkan_bwd(f"fastkan_bwd corner {tag}", x, *lw[:4],
                                                     dout, close, log=log))
            ga = (x, g.senders, g.recv_row_ptr, *lw, 0.25, -2.0, 2.0)
            for w, a, b in zip(("out", "z"), gfk.gin_fastkan_fwd(*ga),
                               gin_fastkan_f64(*ga[:-2])):
                cmp("gin_fastkan", f"gin_fastkan corner {tag} {w}", a[nm], b[nm])
            w_ = rand((G * D, O), dtype, 0.3)
            cmp("rbf_fwd", f"rbf_fwd corner {tag}", rf.rbf_spline_fwd(x, w_, -2.0, 2.0),
                rf.rbf_spline_fwd_plain(x, w_, -2.0, 2.0))
            for w, a, b in zip(("dx", "dW"), rf.rbf_spline_bwd(x, w_, dout, -2.0, 2.0),
                               rf.rbf_spline_bwd_plain(x, w_, dout, -2.0, 2.0)):
                cmp("rbf_bwd", f"rbf_bwd corner {tag} {w}", a, b)
        # the RBF backward at 2,048 outputs: its dx kernels cut them into
        # parts whose shares a sum kernel adds
        for G in (2, 32):
            D, O = 37, 2048
            x, dout = rand((N, D), dtype, 1.5), rand((N, O), dtype)
            w_ = rand((G * D, O), dtype, 0.3)
            for w, a, b in zip(("dx", "dW"), rf.rbf_spline_bwd(x, w_, dout, -2.0, 2.0),
                               rf.rbf_spline_bwd_plain(x, w_, dout, -2.0, 2.0)):
                cmp("rbf_bwd", f"rbf_bwd corner G={G} D={D} O={O} {w}", a, b)
        # the forwards' masked outputs: under one 8-wide n-tile (1, 7), the
        # head's five (40), and two output parts of 256 (512)
        for O in FWD_OUTPUTS:
            D = 64
            knots = make_grid(D, 4, 3, device="cuda").t().contiguous().to(dtype)
            fa = (rand((N, D), dtype), knots, rand((D, O), dtype, 0.3),
                  rand((7 * D, O), dtype, 0.3), 3)
            cmp("bspline_fwd", f"bspline_fwd corner D={D} O={O}", bf.kan_linear_fwd(*fa),
                bf.kan_linear_fwd_plain(*fa))
            lw = (1.0 + rand((D,), dtype, 0.2), rand((D,), dtype, 0.1),
                  rand((4 * D, O), dtype, 0.3), rand((D, O), dtype, 0.3), rand((O,), dtype, 0.1))
            x = rand((N, D), dtype)
            cmp("fastkan_fwd", f"fastkan_fwd corner D={D} O={O}",
                fk.fastkan_layer_fwd(x, *lw, -2.0, 2.0),
                fk.fastkan_layer_fwd_plain(x, *lw, -2.0, 2.0))
        # node 0's 301 valid in-edges: every corner runs the GAT kernels'
        # split of heavy rows
        assert int(g.recv_row_ptr[1].clamp(max=g.n_edge)) > GAT_PIECE
        for H, C in GAT_CORNERS:
            h, dout = rand((N, H * C), dtype), rand((N, H * C), dtype, 0.1)
            asrc, adst = rand((N, H), torch.float32, 2.0), rand((N, H), torch.float32, 2.0)
            tag = f"H={H} C={C}"
            fa = (h, asrc, adst, g.senders, g.recv_row_ptr, g.n_edge, 0.2)
            out, alpha = gfu.gat_fwd(*fa)
            want = gfu.gat_fwd_plain(*fa)
            cmp("gat_fwd", f"gat_fwd corner {tag} out", out, want[0])
            cmp("gat_fwd", f"gat_fwd corner {tag} alpha", alpha, want[1], "float32")
            S = (dout * out).float().reshape(N, H, C).sum(2).contiguous()
            da = (h, asrc, adst, alpha, S, dout, g.senders, g.recv_row_ptr, g.n_edge, 0.2)
            cmp("gat_dadst", f"gat_dadst corner {tag}", gbw.gat_dadst(*da),
                gbw.gat_dadst_plain(*da), "float32")
            sa = (*da[:6], g.receivers_by_sender, g.send_row_ptr, g.n_edge, 0.2)
            for w, a, b in zip(("dh", "dasrc"), gbw.gat_sender(*sa), gbw.gat_sender_plain(*sa)):
                cmp("gat_sender", f"gat_sender corner {tag} {w}", a, b, "float32")
    log(f"corners: {n_cmp} comparisons, all within their bars")


def phase_autograd_functions(torch):
    """FastKANLayerFn -> GcnAggregate -> GinFastKan chained on a small
    graph, then GatAttention twice in a row (kernels/selfcheck.py, shared
    with tests/test_torch_cuda.py)."""
    from kagnn_tpu_torch.graphs import single_graph
    from kagnn_tpu_torch.kernels.selfcheck import (fastkan_gcn_chain,
                                                   gat_attention_chain,
                                                   rbf_chain)

    rng = np.random.default_rng(5)
    g = single_graph(rng.integers(0, 300, 2000), rng.integers(0, 300, 2000),
                     n_node=300, device="cuda")
    worst = fastkan_gcn_chain(g, num_grids=NODE_KW["grid_size"])
    log(f"autograd Functions (FastKANLayerFn, GcnAggregate, GinFastKan): "
        f"forward and 11 gradients agree with the plain path on the CPU "
        f"(worst {worst:.3e}); no A^T dz for an input without a gradient")
    worst = gat_attention_chain(g, heads=NODE_KW["heads"], c=16)
    log(f"autograd Function GatAttention (two layers): forward and 5 "
        f"gradients agree with the plain path on the CPU (worst "
        f"{worst:.3e}); each GAT kernel launched once per layer")
    worst = rbf_chain()
    log(f"autograd Function RbfSplineMatmul (two layers): forward and 3 "
        f"gradients agree with the plain path on the CPU (worst "
        f"{worst:.3e}); each RBF kernel launched once per layer")


# search-space corners of the small-step phase: (conv, architecture,
# settings), one conv each
STEP_CORNERS = (("gin", "kan", dict(spline_order=1, grid_size=8)),
                ("gcn", "kan", dict(spline_order=4, grid_size=16)),
                ("gin", "fastkan", dict(grid_size=32)),
                ("gat", "kan", dict(hidden_channels=37, heads=4)),
                ("gat", "fastkan", dict(hidden_channels=37, heads=4, grid_size=16)))


def phase_small_step(torch, conv, arch, **corner):
    """Kernel path (fused=True) against the plain path on the card, f32 and
    bf16. At the defaults below the plain path is the unfused model
    (fused=False); at a search-space corner's settings (one conv) it is the
    same fused model on the CPU, whose wrappers run the plain versions: the
    fused and unfused formulas round the RBF centers differently (as the
    JAX package's do), which 32 centers amplify past the f32 bar."""
    from kagnn_tpu_torch.data import community_node_graph
    from kagnn_tpu_torch.graphs import single_graph
    from kagnn_tpu_torch.models import NodeClassifier
    from kagnn_tpu_torch.train import masked_softmax_cross_entropy

    d = community_node_graph(n_nodes=300, n_classes=4, num_features=16, seed=0)
    g = single_graph(d["senders"], d["receivers"], nodes=d["nodes"], y=d["y"],
                     device="cuda")
    kw = dict(conv_type=conv, architecture=arch, mp_layers=3,
              num_features=16, hidden_channels=16, num_classes=4,
              grid_size=4, spline_order=3, skip=False)
    if corner:
        kw.update(mp_layers=1, **corner)
    name = f"{conv}/{arch}" + "".join(f" {k}={v}" for k, v in corner.items())

    def run(fused, cd, dev="cuda", state=None):
        m = NodeClassifier(fused=fused, compute_dtype=cd, device=dev, **kw)
        if state is not None:
            m.load_state_dict(state)
        m.train()
        graph = g if dev == "cuda" else g.to(dev)
        logits = m(graph)
        loss = masked_softmax_cross_entropy(logits, graph.y, graph.node_mask)
        loss.backward()
        return (logits.detach().to("cuda"),
                {n: p.grad.to("cuda") for n, p in m.named_parameters()}, m.state_dict())

    nm = g.node_mask
    lk, gk, state = run(True, None)
    lp, gp, _ = run(True, None, "cpu", state) if corner else run(False, None)
    # f32: same tolerances as the CPU parity tests (values rtol 1e-4 /
    # atol 1e-5, grads rtol 1e-3 / atol 1e-5): only summation order differs
    torch.testing.assert_close(lk[nm], lp[nm], rtol=1e-4, atol=1e-5)
    worst = 0.0
    for n in gp:
        torch.testing.assert_close(gk[n], gp[n], rtol=1e-3, atol=1e-5, msg=n)
        worst = max(worst, (gk[n] - gp[n]).abs().max().item())
    log(f"small step {name} f32: logits max_abs_err="
        f"{(lk[nm] - lp[nm]).abs().max().item():.3e}, "
        f"{len(gp)} grads agree (worst {worst:.3e})")
    # bf16 kernel path against the f32 plain path: the test_bf16.py bar
    lb, _, _ = run(True, torch.bfloat16, state=state)
    if corner:
        # bf16 against the same bf16 model on the CPU: the kernels' 4-ulp bar
        # on the logits' scale (both round at the same points)
        lc, _, _ = run(True, torch.bfloat16, "cpu", state)
        err = (lb[nm] - lc[nm]).abs().max().item()
        tol = 4 * BF16_ULP * lc[nm].abs().max().item()
        log(f"small step {name} bf16 vs the CPU: logits max_abs_err={err:.3e} "
            f"(tol {tol:.3e}) {'ok' if err <= tol else 'FAIL'}")
        if not err <= tol:
            raise AssertionError(f"{name}: bf16 kernel path disagrees with its plain "
                                 f"versions: {err} > {tol}")
    rel = ((lb[nm] - lp[nm]).abs().mean() / (lp[nm].abs().mean() + 1e-6)).item()
    log(f"small step {name} bf16 vs f32: mean relative error "
        f"{rel:.4f} (bar 0.1)")
    if not rel < 0.1 and not corner:
        raise AssertionError(f"bf16 kernel path too far from f32: {rel}")


def phase_small_fastkan(torch):
    """The slice's modules on a small node set, kernel path (fused=True)
    against the plain path on the card: the base-free FastKAN([16, 16, 16,
    4]) and the layernorm-free FastKANLayer(16, 4), logits and every
    parameter gradient in f32 (values rtol 1e-4 / atol 1e-5, gradients rtol
    1e-3 / atol 1e-5), then the bf16 kernel path against the f32 plain path
    (the test_bf16.py bar)."""
    from kagnn_tpu_torch.data import community_node_graph
    from kagnn_tpu_torch.kan import FastKAN, FastKANLayer
    from kagnn_tpu_torch.train import masked_softmax_cross_entropy

    d = community_node_graph(n_nodes=300, n_classes=4, num_features=16, seed=0)
    x = torch.from_numpy(d["nodes"]).to("cuda")
    y = torch.from_numpy(d["y"]).to("cuda")
    mask = torch.arange(300, device="cuda") % 3 != 0
    nets = {"FastKAN(use_base_update=False)": lambda **kw: FastKAN(
                [16, 16, 16, 4], num_grids=8, use_base_update=False, **kw),
            "FastKANLayer(use_layernorm=False)": lambda **kw: FastKANLayer(
                16, 4, num_grids=8, use_layernorm=False, **kw)}
    for name, make in nets.items():
        def run(fused, cd):
            m = make(fused=fused, compute_dtype=cd, device="cuda")
            logits = m(x)
            masked_softmax_cross_entropy(logits, y, mask).backward()
            return logits.detach().float(), {n: p.grad for n, p in m.named_parameters()}

        lk, gk = run(True, None)
        lp, gp = run(False, None)
        torch.testing.assert_close(lk, lp, rtol=1e-4, atol=1e-5)
        for n in gp:
            torch.testing.assert_close(gk[n], gp[n], rtol=1e-3, atol=1e-5, msg=n)
        lb, _ = run(True, torch.bfloat16)
        rel = ((lb - lp).abs().mean() / (lp.abs().mean() + 1e-6)).item()
        log(f"small step {name}: f32 logits max_abs_err="
            f"{(lk - lp).abs().max().item():.3e}, {len(gp)} grads agree; bf16 "
            f"vs f32 mean relative error {rel:.4f} (bar 0.1)")
        if not rel < 0.1:
            raise AssertionError(f"{name}: bf16 kernel path too far from f32: {rel}")


def main_graph(torch):
    from kagnn_tpu_torch.data import arxiv_scale_graph
    from kagnn_tpu_torch.graphs import single_graph

    t0 = time.perf_counter()
    d = arxiv_scale_graph()
    g = single_graph(d["senders"], d["receivers"], nodes=d["nodes"], y=d["y"],
                     edge_pad_multiple=1024, device="cuda")
    log(f"arxiv-sized graph: {g.n_node} nodes ({g.n_node_pad} padded), "
        f"{g.n_edge} edges ({g.n_edge_pad} padded), built in "
        f"{time.perf_counter() - t0:.1f} s")
    return g


# The main paths: (conv, architecture) -> launches per train step of each
# kernel on the path (the others must stay at 0). GIN: conv 0's input needs
# no gradient, so no A^T dz there; GCN: every conv's aggregate backward
# runs the segment sum, since dhs feeds the transform's weights.
MAIN_PATHS = {
    ("gin", "kan"): {"gin_fused": 3, "bspline_fwd": 4, "bspline_bwd": 7,
                     "spmm": 2},
    ("gcn", "kan"): {"gcn_agg": 3, "bspline_fwd": 4, "bspline_bwd": 4,
                     "spmm": 3},
    ("gcn", "fastkan"): {"gcn_agg": 3, "fastkan_fwd": 4, "fastkan_bwd": 4,
                         "spmm": 3},
    ("gin", "fastkan"): {"spmm": 5, "fastkan_fwd": 7, "fastkan_bwd": 7},
    ("gat", "kan"): {"bspline_fwd": 4, "bspline_bwd": 4, "gat_fwd": 3,
                     "gat_dadst": 3, "gat_sender": 3},
    ("gat", "fastkan"): {"fastkan_fwd": 4, "fastkan_bwd": 4, "gat_fwd": 3,
                         "gat_dadst": 3, "gat_sender": 3},
    # the MLP baselines: no layer kernel; under bf16 f32 from the first dense
    # product on (gin/mlp's conv-0 sum alone in bf16)
    ("gin", "mlp"): {"spmm": 5},
    ("gcn", "mlp"): {"gcn_agg": 3, "spmm": 3},
    ("gat", "mlp"): {"gat_fwd": 3, "gat_dadst": 3, "gat_sender": 3},
}
# the fusion point FastKAN([128, 64, 64])(x, gin_graph=(g, 0)), forward and
# backward once: the fused GIN+FastKAN layer, the second layer, both layer
# backwards and A^T dz (x needs a gradient)
FUSION_POINT = {"gin_fastkan": 1, "fastkan_fwd": 1, "fastkan_bwd": 2, "spmm": 1}
# the slice's path: FastKAN([128, 64, 64, 40], num_grids=8,
# use_base_update=False, fused, bf16) on the node rows, per train step: each
# layer's layernorm, then the RBF product (x f32, w bf16); every layer's
# input needs a gradient (the layernorm's parameters train)
FASTKAN_PATH = {"rbf_fwd": 3, "rbf_bwd": 3}
# FastKANLayer(128, 64, use_layernorm=False, fused, bf16), forward and
# backward once (the bf16-basis path), and the narrow sum driven once
LN_FREE_LAYER = {"rbf_fwd": 1, "rbf_bwd": 1}
NARROW_DRIVE = {"spmm_narrow": 1}


def check_launches(name, launches, per_run, runs=1):
    """Every kernel launched exactly per_run[k] * runs times (0 if absent)."""
    for k, n in launches.items():
        if n != per_run.get(k, 0) * runs:
            raise AssertionError(f"{name}: {k} launched {n} times in {runs} "
                                 f"runs, expected {per_run.get(k, 0)} per run")


def make_path_model(torch, name):
    """A fresh model of main path `name` (a `conv/architecture` of
    MAIN_PATHS, or fastkan/base-free), fused, bf16, seed 0."""
    from kagnn_tpu_torch.kan import FastKAN
    from kagnn_tpu_torch.models import NodeClassifier

    if name != "fastkan/base-free":
        conv, arch = name.split("/")
        return NodeClassifier(conv_type=conv, architecture=arch, fused=True,
                              compute_dtype=torch.bfloat16, seed=0,
                              device="cuda", **NODE_KW)

    class OnNodes(torch.nn.Module):
        """The net on the graph's node rows (the calling convention of
        make_node_steps)."""

        def __init__(self, net):
            super().__init__()
            self.net = net

        def forward(self, batch):
            return self.net(batch.nodes)

    # the slice's path at full width: the reference fastkan's layers with
    # use_base_update=False trained full-batch on the node features
    return OnNodes(FastKAN([NODE_KW["num_features"], NODE_KW["hidden_channels"],
                            NODE_KW["hidden_channels"], NODE_KW["num_classes"]],
                           num_grids=RBF_G, use_base_update=False, fused=True,
                           compute_dtype=torch.bfloat16, device="cuda"))


def phase_main_path(torch, g, conv, arch):
    name = f"{conv}/{arch}"
    return drive_path(torch, g, name, make_path_model(torch, name),
                      MAIN_PATHS[(conv, arch)])


def phase_fastkan_path(torch, g):
    return drive_path(torch, g, "fastkan/base-free",
                      make_path_model(torch, "fastkan/base-free"), FASTKAN_PATH)


CAPTURED_STEPS = 10  # steps of one CUDA graph (make_node_multi_step)


def phase_captured(torch, g, name, per_step):
    """Path `name`'s bf16 step captured by `make_node_multi_step` (Adam with
    capturable=True): the first call (the warm-up steps, the capture of
    CAPTURED_STEPS steps, a replay) with the launch counters checked at
    (WARMUP_STEPS + CAPTURED_STEPS) x per_step, then a timed replay whose
    counts must stay 0, and the peak memory of the captured run; against
    2 x CAPTURED_STEPS eager steps of a fresh model with the same Adam (its
    first under torch.cuda.set_sync_debug_mode("error"): no step syncs with
    the host; the second half timed), which the captured losses must equal
    bit for bit, and eager steps with the default Adam, within the bf16 step
    bar (4 bf16 ulps of each loss). Returns (captured ms/step, eager
    ms/step)."""
    from kagnn_tpu_torch.train import make_node_multi_step, make_node_steps
    from kagnn_tpu_torch.train.loops import WARMUP_STEPS

    n, mask = CAPTURED_STEPS, g.node_mask

    def adam(m, capturable):
        return torch.optim.Adam(m.parameters(), lr=1e-3, capturable=capturable)

    def eager_run(capturable):
        model = make_path_model(torch, name)
        step, _ = make_node_steps(model, adam(model, capturable))
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            losses = [step(g, mask)]
        finally:
            torch.cuda.set_sync_debug_mode("default")
        losses += [step(g, mask) for _ in range(n - 1)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses += [step(g, mask) for _ in range(n)]
        torch.cuda.synchronize()
        return torch.stack(losses), (time.perf_counter() - t0) * 1e3 / n

    eager, eager_ms = eager_run(True)
    default, _ = eager_run(False)
    model = make_path_model(torch, name)
    multi = make_node_multi_step(model, adam(model, True), n)
    res = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counted(torch, f"captured {name}: warm-up and capture", per_step,
            lambda: res.update(first=multi(g, mask)), WARMUP_STEPS + n)
    peak = torch.cuda.max_memory_allocated() / 2**30
    t0 = time.perf_counter()
    counted(torch, f"captured {name}: replay", {},
            lambda: res.update(second=multi(g, mask)))
    cap_ms = (time.perf_counter() - t0) * 1e3 / n
    captured = torch.cat([res["first"], res["second"]])
    same = torch.equal(captured, eager)
    err = ((captured - default).abs() / default.abs()).max().item()
    log(f"captured {name}: {n} steps a graph, ms/step captured={cap_ms:.3f} "
        f"eager={eager_ms:.3f} (Adam capturable), peak_mem={peak:.3f} GiB; "
        f"losses {captured[0].item():.5f} -> {captured[-1].item():.5f}, "
        f"{'bit for bit' if same else 'NOT equal to'} the eager ones, against "
        f"the default Adam {err / (4 * BF16_ULP):.4f} of the 4-ulp bar")
    if not same:
        raise AssertionError(f"captured {name}: losses differ from the eager "
                             f"steps: {captured.tolist()} vs {eager.tolist()}")
    if not err <= 4 * BF16_ULP:
        raise AssertionError(f"captured {name}: losses off the default Adam's "
                             f"by {err}")
    return cap_ms, eager_ms


def drive_path(torch, g, name, model, per_step):
    """2 warm-up + 10 timed bf16 train steps (masked CE, Adam(1e-3)) with
    the launch counters set to 0 before and checked after, then the host
    enqueue time of one step, an evaluation and a profile. Returns the
    launches, ms/step and the profiled device ms per step by kernel."""
    from kagnn_tpu_torch.train import make_node_steps

    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    train_step, evaluate = make_node_steps(model, opt)
    mask = g.node_mask
    warmup, timed = 2, 10
    res = {}

    def run():
        torch.cuda.reset_peak_memory_stats()
        losses = [train_step(g, mask) for _ in range(warmup)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses += [train_step(g, mask) for _ in range(timed)]
        torch.cuda.synchronize()
        res["ms"] = (time.perf_counter() - t0) * 1e3 / timed
        res["losses"] = [float(v) for v in losses]

    launches = counted(torch, f"main path {name}", per_step, run, warmup + timed)
    ms, vals = res["ms"], res["losses"]
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"main path {name}: {warmup}+{timed} steps, ms/step={ms:.3f}, "
        f"peak_mem={peak:.3f} GiB, losses {vals[0]:.5f} -> {vals[-1]:.5f}")
    if not all(math.isfinite(v) for v in vals):
        raise AssertionError(f"non-finite loss on {name}: {vals}")
    # host cost of one step: the time to enqueue it on an idle card
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    train_step(g, mask)
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    log(f"main path {name}: host enqueue {host_ms:.3f} ms for one step")
    logits = evaluate(g)
    if logits.shape != (g.n_node_pad, NODE_KW["num_classes"]) or \
            not torch.isfinite(logits[mask]).all():
        raise AssertionError(f"{name}: evaluate gave non-finite or misshapen "
                             f"logits")
    by_kernel = profile_steps(torch, lambda: train_step(g, mask), ms)
    return launches, ms, by_kernel


def profile_steps(torch, step, step_ms, steps=3):
    """Device time per step by kernel, from torch.profiler over a few main
    path steps (after the counted run, so its launches are not counted).
    The busy share compares the summed kernel time with the timed run's
    ms/step; the profiler's own overhead is outside both. Returns device ms
    per step by kernel name (empty when the profiler saw none)."""
    from kagnn_tpu_torch.utils.profiling import device_profile

    torch.cuda.synchronize()
    prof = device_profile(lambda: [step() for _ in range(steps)], steps)
    if prof.ms is None:
        log("profile: the profiler saw no device time (not measured)")
        return {}
    log(f"profile: {prof.ms:.3f} ms of kernels per step, busy share "
        f"{prof.ms / step_ms:.3f} of the timed {step_ms:.3f} ms/step")
    for key, t, calls in prof.kernels[:15]:
        log(f"  {t:8.4f} ms/step {calls:4d} calls/step "
            f"{t / prof.ms:6.3f}  {key[:90]}")
    # the host side: self CPU time by operator (inflated by the profiler's
    # own cost, so only the order is read)
    log(f"  host: {sum(t for _, t, _ in prof.host):.3f} ms of self CPU time "
        f"per step under the profiler; the largest:")
    for key, t, calls in prof.host[:8]:
        log(f"  {t:8.4f} ms/step {calls:4d} calls/step  {key[:70]}")
    return {key: t for key, t, _ in prof.kernels}


def phase_fusion_point(torch, g):
    """FastKAN([128, 64, 64], fused, bf16)(x, gin_graph=(g, 0.0)) on the
    main graph, forward and backward once, with the counters set to 0
    before and read after (FUSION_POINT). Returns the launches."""
    from kagnn_tpu_torch.kan import FastKAN

    net = FastKAN([NODE_KW["num_features"], NODE_KW["hidden_channels"],
                   NODE_KW["hidden_channels"]], num_grids=NODE_KW["grid_size"],
                  fused=True, compute_dtype=torch.bfloat16, device="cuda")
    return drive_once(torch, g, "fusion point FastKAN(x, gin_graph=(g, 0))",
                      FUSION_POINT, lambda x: net(x, gin_graph=(g, 0.0)))[0]


def launches_of(torch, name, run):
    """run() with every launch counter set to 0 just before and read just
    after; logs and returns the counts."""
    from kagnn_tpu_torch.kernels import launch_counters

    fns = launch_counters()
    torch.cuda.synchronize()
    for f in fns.values():
        f.launches = 0
    run()
    torch.cuda.synchronize()
    launches = {k: f.launches for k, f in fns.items()}
    log(f"{name} launches: {launches}")
    return launches


def counted(torch, name, per_run, run, runs=1):
    """run() counted (`launches_of`); checks the counts against per_run *
    runs and returns them."""
    launches = launches_of(torch, name, run)
    check_launches(name, launches, per_run, runs)
    return launches


def drive_once(torch, g, name, per_run, forward):
    """forward(x) on a copy of the main graph's node rows that needs a
    gradient, and the backward of its masked sum, once and counted; raises
    on a non-finite output or gradient. Returns (launches, output)."""
    x = g.nodes.detach().clone().requires_grad_(True)
    res = {}

    def run():
        res["out"] = forward(x)
        res["out"][g.node_mask].float().sum().backward()

    launches = counted(torch, name, per_run, run)
    if not (torch.isfinite(res["out"][g.node_mask]).all()
            and torch.isfinite(x.grad).all()):
        raise AssertionError(f"{name}: non-finite output or gradient")
    return launches, res["out"]


def phase_ln_free_layer(torch, g):
    """FastKANLayer(128, 64, num_grids=8, use_layernorm=False, fused, bf16)
    on the main graph's node rows, forward and backward once: the RBF
    product of a bf16 x with the bf16 basis, plus the base update."""
    from kagnn_tpu_torch.kan import FastKANLayer

    layer = FastKANLayer(NODE_KW["num_features"], NODE_KW["hidden_channels"],
                         num_grids=RBF_G, use_layernorm=False, fused=True,
                         compute_dtype=torch.bfloat16, device="cuda")
    launches, out = drive_once(torch, g, "layernorm-free FastKANLayer",
                               LN_FREE_LAYER, layer)
    if out.dtype != torch.bfloat16:
        raise AssertionError(f"layernorm-free layer: output in {out.dtype}")
    return launches


def phase_narrow_drive(torch, g):
    """sorted_segment_sum_narrow of (E, 4) f32 per-edge values (a 4-head
    GAT's) over the main graph's receivers, once: no model path calls it."""
    from kagnn_tpu_torch.kernels import spmm

    vals = torch.randn(g.n_edge_pad, 4, device="cuda")
    res = {}
    launches = counted(torch, "narrow segment sum", NARROW_DRIVE, lambda: res.update(
        out=spmm.sorted_segment_sum_narrow(vals, g.receivers, g.n_node_pad)))
    if res["out"].shape != (g.n_node_pad, 4) or not torch.isfinite(res["out"]).all():
        raise AssertionError("narrow segment sum: misshapen or non-finite output")
    return launches


# The graph paths at full width, bf16 over f32 master weights, Adam(1e-3),
# fused: G is bench.py's graphcls configuration (GraphClassifier gin/kan,
# 3 convs, 21 one-hot atom features, hidden 64, 2 classes, update nets and
# head of 2 layers; 2,048 synthetic molecules of 10-40 atoms, seed 3, in
# shuffled batches of 256 from the native assembler, prefetch 2), R the ZINC
# defaults of experiments/graph_regression.py (GraphRegressor gin/kan, 4
# GINE convs, OGB encoders, hidden 64; the same molecules with regression
# targets and bond features, from batch_graphs, which takes edge features,
# prefetch 2). Launches per train step: G's convs fuse their aggregate into
# the first KANLinear; the second layer and the head's two run the layer
# forward, every layer the backward; the segment sum computes A^T dz at
# convs 1 and 2 and the pool. R's GINE convs each sum their f32 messages and
# the gradient to x (the encoder's output needs one; bf16, x's dtype), the
# pool (bf16) once more.
GRAPH_PATHS = {
    "G": {"gin_fused": 3, "bspline_fwd": 5, "bspline_bwd": 8, "spmm": 3},
    "R": {"bspline_fwd": 10, "bspline_bwd": 10, "spmm": 9},
}
GRAPH_BATCH = 256
GRAPH_TIMED_EPOCHS = 2
# the 15 graph paths of the small-step phase: (task, conv, architecture)
SMALL_GRAPH_PATHS = ([("G", c, a) for c in ("gin", "gcn", "gat")
                      for a in ("mlp", "kan", "fastkan")]
                     + [("R", c, a) for c in ("gin", "gcn")
                        for a in ("mlp", "kan", "fastkan")])


def graph_data(task, n=2048):
    """G: random_molecule_graphs(n, 10, 40, seed=3) with one-hot(21) atom
    features and no bond features (bench.py's graphcls data); R: the same
    molecules with regression targets, atom and bond columns."""
    from kagnn_tpu_torch.data import random_molecule_graphs

    if task == "R":
        return random_molecule_graphs(n, 10, 40, seed=3, target="regression")
    graphs = random_molecule_graphs(n_graphs=n, min_nodes=10, max_nodes=40, seed=3)
    for g in graphs:
        g["nodes"] = np.eye(21, dtype=np.float32)[g["nodes"][:, 0]]
        g["edges"] = None
    return graphs


def graph_model(torch, task, conv="gin", arch="kan", fused=True,
                dtype="bfloat16", device="cuda", **kw):
    """A graph model of task G or R (at full width unless kw says
    otherwise), seed 0."""
    from kagnn_tpu_torch.models import GraphClassifier, GraphRegressor

    cd = None if dtype is None else getattr(torch, dtype)
    common = dict(hidden_dim=64, hidden_layers=2, grid_size=4, spline_order=3,
                  fused=fused, compute_dtype=cd, seed=0, device=device)
    common.update(kw)
    if task == "G":
        common.setdefault("gnn_layers", 3)
        return GraphClassifier(conv, arch, num_features=21, num_classes=2,
                               **common)
    common.setdefault("gnn_layers", 4)
    return GraphRegressor(conv, arch, num_node_features=1, num_edge_features=1,
                          ogb_encoders=True, **common)


def graph_steps(torch, task, model):
    from kagnn_tpu_torch.train import make_graph_cls_steps, make_graph_reg_steps

    make = make_graph_cls_steps if task == "G" else make_graph_reg_steps
    return make(model, torch.optim.Adam(model.parameters(), lr=1e-3))


def graph_loss(task, out, g):
    from kagnn_tpu_torch.train import masked_l1, masked_nll

    if task == "G":
        return masked_nll(out, g.y, g.graph_mask)
    return masked_l1(out, g.y, g.graph_mask)


def host_assembly_ms(assemble, sels):
    """Host ms per batch of assemble(sel) over the selections (host
    batches: no copy to the card)."""
    assemble(sels[0])
    t0 = time.perf_counter()
    for sel in sels:
        assemble(sel)
    return (time.perf_counter() - t0) * 1e3 / len(sels)


def phase_graph_path(torch, task, rows):
    """Graph path `task` at full width through its entry points
    (batch_loader -> make_graph_*_steps): host assembly alone (native and
    numpy for G, numpy for R), one warm-up epoch, then GRAPH_TIMED_EPOCHS
    epochs timed by the host clock (ending in a synchronize) with the launch
    counters set to 0 before and checked after; the loader alone, the
    prefetch worker's staging of a batch alone (pinning it and issuing its
    copies), the steps fed without prefetch, the step alone on one batch
    already on the card, the host syncs of one step, peak memory, the busy
    share and top kernels over 3 profiled steps, an evaluation, and a
    prefetched epoch against the same batches moved synchronously (a train
    step consuming each prefetched batch first). On the first batch the path takes on the card, its
    kernels at the path's widths against their functions summed in f64:
    the pool, GINE's aggregate and GINE's gradient to x at D 64
    (`check_graph_sums`), and for G gin_fused at D 21 -> 64 and 64 -> 64
    (`check_gin_split`), over the batch's pad row (about 10,700 padded
    edges) and pad graph, in f32 and bf16. Returns the launches, ms/step
    fed without and with prefetch (the first the headline while the
    prefetching loader costs the host-bound steps time) and the profiled
    device ms per step by kernel."""
    from kagnn_tpu_torch.data.native import NativeBatchAssembler
    from kagnn_tpu_torch.graphs import batch_graphs, pad_spec_for
    from kagnn_tpu_torch.kernels.selfcheck import (check_gin_split,
                                                   check_graph_sums,
                                                   check_prefetch)
    from kagnn_tpu_torch.train.experiments import batch_loader
    from kagnn_tpu_torch.train.prefetch import stage_batch
    from kagnn_tpu_torch.utils.time_graph_loader import staging_ms

    graphs = graph_data(task)
    spec = pad_spec_for(graphs, GRAPH_BATCH)
    native = task == "G"
    per_epoch = -(-len(graphs) // GRAPH_BATCH)
    sels = [np.random.default_rng(i).permutation(len(graphs))[:GRAPH_BATCH]
            for i in range(per_epoch)]
    asm = {}
    if native:
        nat = NativeBatchAssembler(graphs, spec)
        asm["native"] = host_assembly_ms(lambda s: nat.assemble(s, device="cpu"), sels)
    asm["numpy"] = host_assembly_ms(lambda s: batch_graphs(
        [graphs[j] for j in s], spec, device="cpu"), sels)
    log(f"graph path {task}: {len(graphs)} molecules, PadSpec {spec}; host "
        f"assembly ms per batch: " + ", ".join(f"{k} {v:.3f}" for k, v in asm.items()))
    model = graph_model(torch, task)
    step, evaluate = graph_steps(torch, task, model)
    loader = batch_loader(graphs, spec, GRAPH_BATCH, shuffle=True, seed=0,
                          native=native, prefetch=2)
    for b in loader():
        step(b)
    res = {}

    def run():
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        losses = [step(b) for _ in range(GRAPH_TIMED_EPOCHS) for b in loader()]
        torch.cuda.synchronize()
        res["s"] = time.perf_counter() - t0
        res["losses"] = [float(v) for v in losses]

    steps = GRAPH_TIMED_EPOCHS * per_epoch
    launches = counted(torch, f"graph path {task}", GRAPH_PATHS[task], run, steps)
    ms, vals = res["s"] * 1e3 / steps, res["losses"]
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"graph path {task}: {steps} steps, ms/step={ms:.3f}, graphs/s="
        f"{GRAPH_TIMED_EPOCHS * len(graphs) / res['s']:.1f}, peak_mem={peak:.3f} "
        f"GiB, losses {vals[0]:.5f} -> {vals[-1]:.5f}")
    if not all(math.isfinite(v) for v in vals):
        raise AssertionError(f"graph path {task}: non-finite loss: {vals}")
    # the loader alone (assembly and copies, no step), and the steps fed by
    # a loader without prefetch (each batch assembled and copied when asked
    # for, on the dispatching thread), ms per batch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in loader():
        pass
    torch.cuda.synchronize()
    loader_alone = (time.perf_counter() - t0) * 1e3 / per_epoch
    sync_loader = batch_loader(graphs, spec, GRAPH_BATCH, shuffle=True, seed=0,
                               native=native)
    t0 = time.perf_counter()
    for b in sync_loader():
        step(b)
    torch.cuda.synchronize()
    no_prefetch = (time.perf_counter() - t0) * 1e3 / per_epoch
    # the worker's staging alone: host batches pinned and their copies
    # issued on a side stream, one at a time
    host = [nat.assemble(s, device="cpu") if native else
            batch_graphs([graphs[j] for j in s], spec, device="cpu") for s in sels]
    stage_ms = staging_ms(host, stage_batch)
    log(f"graph path {task}: ms per batch of the prefetching loader alone "
        f"{loader_alone:.3f}; the worker's staging alone (pin, issue the "
        f"copies) {stage_ms:.3f} beside assembly {asm['native' if native else 'numpy']:.3f}; "
        f"ms/step fed without prefetch {no_prefetch:.3f}, with prefetch {ms:.3f} "
        f"(utils/time_graph_loader.py times them in rounds)")
    b0 = next(iter(loader()))
    gen = torch.Generator(device="cuda").manual_seed(13)
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[1]
        close = lambda name, a, b, dn=dn: compare(  # noqa: E731
            torch, f"graph path {task} {name}", a, b, dn)
        record_row(rows["spmm"], check_graph_sums(b0, 64, dtype, close, gen), False)
        if task == "G":
            for d in (21, 64):
                record_row(rows["gin_fused"], check_gin_split(
                    b0, d, 64, dtype, close, gen), False)
    # the step alone, on one batch already on the card (no loader)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(per_epoch):
        step(b0)
    torch.cuda.synchronize()
    alone = (time.perf_counter() - t0) * 1e3 / per_epoch
    log(f"graph path {task}: ms/step on one batch already on the card "
        f"(no loader) {alone:.3f}")
    out = evaluate(b0)
    if not all(torch.isfinite(v).all() for v in out) or int(out[-1]) != GRAPH_BATCH:
        raise AssertionError(f"graph path {task}: evaluate gave {out}")
    # host syncs of one step (each stalls the host until the card catches
    # up, which an eager step that is host-bound cannot afford)
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            step(b0)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = [str(w.message).splitlines()[0][:80] for w in caught
             if "synchroniz" in str(w.message)]
    log(f"graph path {task}: {len(syncs)} host syncs in one step"
        + (": " + "; ".join(sorted(set(syncs))) if syncs else ""))
    by_kernel = profile_steps(torch, lambda: step(b0), ms)
    n = check_prefetch(graphs, spec, GRAPH_BATCH, native, consume=step)
    log(f"graph path {task}: {n} prefetched batches equal the synchronously "
        f"moved ones field by field")
    return launches, {"no prefetch": no_prefetch, "prefetch 2": ms}, by_kernel


def phase_small_graph_steps(torch):
    """Each of the 15 graph paths (2 convs, hidden 16, 4 GAT heads) on one
    batch of 16 molecules: the kernel path on the card against the same
    model's plain path on the CPU, same weights. f32: outputs rtol 1e-4 /
    atol 1e-5, every parameter gradient rtol 1e-3 / atol 1e-5. bf16:
    outputs and the loss within 4 bf16 ulps of their scale; each gradient
    against the CPU bf16 and f32 gradients by `selfcheck.bf16_grad_ratios`
    at its scale (the largest gradient of its conv for a BatchNorm-fed bias
    or a GAT att_src/att_dst, whose exact gradients (nearly) cancel), the
    bars of tests/test_torch_graph_steps.py."""
    import re

    from kagnn_tpu_torch.graphs import batch_graphs, pad_spec_for
    from kagnn_tpu_torch.kernels.selfcheck import bf16_grad_ratios

    noisy = re.compile(r"convs\.\d+\.(att_src|att_dst|update\.layers\.1\.base_linear\.bias)")
    for task, conv, arch in SMALL_GRAPH_PATHS:
        graphs = graph_data(task, 16)
        g = batch_graphs(graphs, pad_spec_for(graphs, 16), device="cuda")
        gm = g.graph_mask
        name = f"{task} {conv}/{arch}"

        def run(dtype, dev, state=None):
            m = graph_model(torch, task, conv, arch, dtype=dtype, device=dev,
                            gnn_layers=2, hidden_dim=16)
            if state is not None:
                m.load_state_dict(state)
            m.train()
            graph = g if dev == "cuda" else g.to(dev)
            out = m(graph)
            loss = graph_loss(task, out, graph)
            loss.backward()
            return (out.detach().to("cuda"), loss.detach().to("cuda"),
                    {n: p.grad.to("cuda") for n, p in m.named_parameters()},
                    m.state_dict())

        ok, lk, gk, state = run(None, "cuda")
        op, lp, gp, _ = run(None, "cpu", state)
        torch.testing.assert_close(ok[gm], op[gm], rtol=1e-4, atol=1e-5)
        for n in gp:
            torch.testing.assert_close(gk[n], gp[n], rtol=1e-3, atol=1e-5, msg=n)
        ob, lb, gb, _ = run("bfloat16", "cuda", state)
        oc, lc, gc, _ = run("bfloat16", "cpu", state)
        out_err = (ob[gm] - oc[gm]).abs().max().item()
        out_tol = 4 * BF16_ULP * oc[gm].abs().max().item()
        loss_err = abs(lb.item() - lc.item())
        worst = [0.0, 0.0]
        for n in gc:
            conv_max = max(v.abs().max().item() for k, v in gc.items()
                           if k.startswith(".".join(n.split(".")[:2]) + "."))
            scale = conv_max if noisy.fullmatch(n) else gc[n].abs().max().item()
            ratios = bf16_grad_ratios(*(t[n].cpu().numpy() for t in (gb, gc, gp)), scale)
            worst = [max(w, r) for w, r in zip(worst, ratios)]
        log(f"small graph step {name}: f32 out max_abs_err="
            f"{(ok[gm] - op[gm]).abs().max().item():.3e}, {len(gp)} grads agree; "
            f"bf16 out {out_err:.3e} (tol {out_tol:.3e}), loss {loss_err:.3e}, "
            f"worst grad err/bar against the CPU bf16 {worst[0]:.3f}, against "
            f"the CPU f32 {worst[1]:.3f}")
        if not (out_err <= out_tol and loss_err <= 4 * BF16_ULP * abs(lc.item())
                and max(worst) <= 1.0):
            raise AssertionError(f"small graph step {name}: the bf16 kernel path "
                                 f"disagrees with its plain versions")


# ------------------------------------------------------------ protocol layer
# phase_protocol: the port's parsers, protocol runners and experiment drivers
# on data written in each format's raw layout into a temporary directory.

# the drivers' --random_seed default and the trials each driver of (b)-(d)
# runs: all within the TPE's random start-up trials (TPESampler's
# n_startup_trials, 8), so their shapes do not depend on the objective and
# phase_build builds them with the others
PROTOCOL_SEED = 12345
PROTOCOL_TRIALS = 8
# ogbn-arxiv's time split: train / valid / test nodes
ARXIV_SPLIT = (90_941, 29_799, 48_603)
# drive (a): run_node_experiment at the flagship widths (gin/kan, 3 convs
# from DATASET_LAYERS, hidden 64, grid 4, order 3, 2-layer update nets, the
# node driver's default skip), fused, bf16, Adam 1e-3, no dropout, renumbered
# by rcm, grids adapted every 2 epochs (before epochs 2 and 4)
FLAGSHIP_PARAMS = dict(conv_type="gin", architecture="kan", hidden_channels=64,
                       grid_size=4, spline_order=3, hidden_layers=2, skip=1,
                       heads=4, fused=True, bf16=True, lr=1e-3, dropout=0.0,
                       reorder="rcm", update_grid=2, epochs=5, patience=100)
PROTOCOL_SPLITS = 2
# launches of one evaluation (a forward in eval mode) of the flagship model;
# a train step launches MAIN_PATHS[("gin", "kan")]
FLAGSHIP_EVAL = {"gin_fused": 3, "bspline_fwd": 4}
SAMPLED = dict(fanouts=[10, 5], batch_size=512)
# the kernels each driver of (b)-(d) launches (every other stays at 0)
DRIVER_KERNELS = {
    "b": {"gcn_agg", "spmm", "fastkan_fwd", "fastkan_bwd"},
    "c": {"gat_fwd", "gat_dadst", "gat_sender", "bspline_fwd", "bspline_bwd", "spmm"},
    "d": {"spmm", "fastkan_fwd", "fastkan_bwd"},
}


def protocol_trials() -> dict:
    """The hyperparameters of the PROTOCOL_TRIALS trials of drivers (b)-(d):
    the port's TPE study at the seed each driver gives it, run on a constant
    objective (start-up trials draw at random whatever the values)."""
    from kagnn_tpu_torch.experiments import graph_classification as gc
    from kagnn_tpu_torch.experiments import graph_regression as gr
    from kagnn_tpu_torch.experiments import node_classification as nc
    from kagnn_tpu_torch.train.hpo import TPESampler, create_study

    if PROTOCOL_TRIALS > TPESampler().n_startup:
        raise AssertionError("the protocol drives must stay within the random trials")

    def draw(space):
        out = []
        study = create_study(sampler=TPESampler(seed=PROTOCOL_SEED))
        study.optimize(lambda t: (out.append(space(t)), 0.0)[1],
                       n_trials=PROTOCOL_TRIALS)
        return out

    return {"b": draw(lambda t: nc.search_space(t, "gcn", "fastkan")),
            "c": draw(lambda t: gc.search_space(t, "kan")),
            "d": draw(lambda t: gr.search_space(t, "fastkan"))}


def protocol_units() -> list:
    """The libraries the trials of drivers (b)-(d) need: the FastKAN layer at
    (b)'s and (d)'s center counts, the B-spline layer at (c)'s (order,
    grid)."""
    p = protocol_trials()
    units = {("fastkan_layer", (t["grid_size"],)) for t in p["b"] + p["d"]}
    units |= {("bspline_fused", (t["spline_order"], t["grid_size"])) for t in p["c"]}
    return sorted(units)


def write_ogbn_arxiv(root, d):
    """arxiv_scale_graph's d in the extracted OGB layout of ogbn-arxiv:
    raw/{edge,node-feat,node-label}.csv.gz (the directed edges, the features
    to 6 decimals as OGB writes them) and split/time/{train,valid,test}.csv.gz
    (ARXIV_SPLIT nodes of a seeded permutation)."""
    import gzip

    base = os.path.join(root, "ogbn-arxiv", "arxiv")
    for sub in ("raw", os.path.join("split", "time")):
        os.makedirs(os.path.join(base, sub), exist_ok=True)

    def wcsv(path, arr, fmt):
        with gzip.open(os.path.join(base, path), "wt", compresslevel=1) as f:
            np.savetxt(f, arr, delimiter=",", fmt=fmt)

    wcsv("raw/edge.csv.gz", np.stack([d["senders"], d["receivers"]], 1), "%d")
    wcsv("raw/node-feat.csv.gz", d["nodes"], "%.6f")
    wcsv("raw/node-label.csv.gz", d["y"][:, None], "%d")
    perm = np.random.default_rng(0).permutation(d["n_node"])
    cuts = np.cumsum(ARXIV_SPLIT)[:-1]
    for name, ids in zip(("train", "valid", "test"), np.split(perm, cuts)):
        wcsv(f"split/time/{name}.csv.gz", np.sort(ids), "%d")


def write_planetoid_cora(root, seed=0):
    """A Cora-shaped Planetoid raw set, ind.cora.{x,y,allx,ally,tx,ty,graph}
    pickles (scipy CSR features, one-hot labels, the graph as an adjacency
    dict) and ind.cora.test.index (the test nodes 1,708-2,707 listed
    permuted): 2,708 nodes, 1,433 binary features (about 1.3 % set), 7
    classes, a community graph; synthetic content."""
    import pickle

    import scipy.sparse as sp

    from kagnn_tpu_torch.data import community_node_graph

    n, f, c, n_allx = 2708, 1433, 7, 1708
    d = community_node_graph(n_nodes=n, n_classes=c, num_features=4, seed=seed)
    rng = np.random.default_rng(seed)
    feats = (rng.random((n, f)) < 0.0127).astype(np.float32)
    feats[np.arange(n), rng.integers(0, f, n)] = 1.0
    onehot = np.eye(c)[d["y"]]
    raw = os.path.join(root, "Cora", "Cora", "raw")
    os.makedirs(raw, exist_ok=True)
    listed = rng.permutation(np.arange(n_allx, n))
    graph: dict = {}
    for s, r in zip(d["senders"].tolist(), d["receivers"].tolist()):
        graph.setdefault(s, []).append(r)
    for suf, obj in (("x", sp.csr_matrix(feats[:140])), ("y", onehot[:140]),
                     ("allx", sp.csr_matrix(feats[:n_allx])), ("ally", onehot[:n_allx]),
                     ("tx", sp.csr_matrix(feats[listed])), ("ty", onehot[listed]),
                     ("graph", graph)):
        with open(os.path.join(raw, f"ind.cora.{suf}"), "wb") as fh:
            pickle.dump(obj, fh, protocol=2)
    with open(os.path.join(raw, "ind.cora.test.index"), "w") as fh:
        fh.write("\n".join(str(i) for i in listed) + "\n")


def write_tu_mutag(root, seed=0):
    """188 random molecules (MUTAG's count: the fixture folds index them) in
    the TU text layout: MUTAG_A.txt (1-based node ids over the dataset),
    MUTAG_graph_indicator.txt, MUTAG_graph_labels.txt (1 and -1),
    MUTAG_node_labels.txt (7 atom types) and MUTAG_edge_labels.txt."""
    from kagnn_tpu_torch.data import random_molecule_graphs

    graphs = random_molecule_graphs(188, 10, 28, num_atom_types=7,
                                    num_bond_types=4, seed=seed)
    # two classes of 94: the mean atom type above its median or not
    mean_atom = np.array([g["nodes"].mean() for g in graphs])
    label = np.argsort(np.argsort(mean_atom, kind="stable")) >= 94
    raw = os.path.join(root, "MUTAG", "MUTAG", "raw")
    os.makedirs(raw, exist_ok=True)
    offsets = np.cumsum([0] + [g["n_node"] for g in graphs])
    cols = {k: [] for k in ("A", "graph_indicator", "node_labels", "edge_labels")}
    for gid, (g, off) in enumerate(zip(graphs, offsets)):
        cols["A"] += [f"{s + off + 1}, {r + off + 1}"
                      for s, r in zip(g["senders"], g["receivers"])]
        cols["graph_indicator"] += [str(gid + 1)] * g["n_node"]
        cols["node_labels"] += [str(a) for a in g["nodes"][:, 0]]
        cols["edge_labels"] += [str(b) for b in g["edges"][:, 0]]
    cols["graph_labels"] = [("1" if v else "-1") for v in label]
    for k, lines in cols.items():
        with open(os.path.join(raw, f"MUTAG_{k}.txt"), "w") as fh:
            fh.write("\n".join(lines) + "\n")


def write_zinc(root, counts=(10_000, 1_000, 1_000), seed=0):
    """The ZINC subset layout: ZINC/raw/{train,val,test}.pickle, each a list
    of molecules {atom_type: LongTensor (n,), bond_type: LongTensor (n, n)
    adjacency of bond types 1-3, logP_SA_cycle_normalized: tensor}, as the
    benchmarking-gnns release pickles them (random molecules of 9-38 atoms of
    28 types)."""
    import pickle

    import torch

    from kagnn_tpu_torch.data import random_molecule_graphs

    raw = os.path.join(root, "ZINC", "raw")
    os.makedirs(raw, exist_ok=True)
    mols = random_molecule_graphs(sum(counts), 9, 38, num_atom_types=28,
                                  num_bond_types=3, seed=seed, target="regression")
    start = 0
    for split, n in zip(("train", "val", "test"), counts):
        out = []
        for g in mols[start:start + n]:
            adj = np.zeros((g["n_node"], g["n_node"]), np.int64)
            adj[g["senders"], g["receivers"]] = g["edges"][:, 0] + 1
            out.append({"atom_type": torch.from_numpy(g["nodes"][:, 0].astype(np.int64)),
                        "bond_type": torch.from_numpy(adj),
                        "logP_SA_cycle_normalized": torch.tensor(float(g["y"][0]))})
        with open(os.path.join(raw, f"{split}.pickle"), "wb") as fh:
            pickle.dump(out, fh)
        start += n


class ProtocolProbe:
    """Times and counts what `run_node_experiment` reaches through module
    attributes, without changing what it computes: each train step and
    evaluation (synchronized before and after; its launches), each grid
    adaptation, the reorder (its output kept) and each split's result.
    Installed with `with ProtocolProbe(torch) as probe:`; restored on exit."""

    def __init__(self, torch):
        import kagnn_tpu_torch.graphs.reorder as R
        import kagnn_tpu_torch.kan.adapt as A
        import kagnn_tpu_torch.train.experiments as E
        from kagnn_tpu_torch.kernels import launch_counters

        self.torch, self.events = torch, []
        self._fns = launch_counters()
        self._patch = [(E, "make_node_steps"), (E, "train_node_total"),
                       (A, "adapt_model_grids"), (R, "reorder_graph")]

    def _launches(self):
        return {k: f.launches for k, f in self._fns.items()}

    def _timed(self, kind, fn, keep=False):
        torch = self.torch

        def wrapper(*a, **kw):
            before = self._launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            delta = {k: v - before[k] for k, v in self._launches().items() if v != before[k]}
            self.events.append((kind, secs, delta, out if keep else None))
            return out
        return wrapper

    def __enter__(self):
        self._saved = [getattr(m, n) for m, n in self._patch]
        make_steps = self._saved[0]

        def make_node_steps(model, opt):
            step, evaluate = make_steps(model, opt)
            return self._timed("step", step, keep=True), self._timed("eval", evaluate)

        new = [make_node_steps, self._timed("split", self._saved[1], keep=True),
               self._timed("adapt", self._saved[2]), self._timed("reorder", self._saved[3], keep=True)]
        for (m, n), f in zip(self._patch, new):
            setattr(m, n, f)
        return self

    def __exit__(self, *exc):
        for (m, n), f in zip(self._patch, self._saved):
            setattr(m, n, f)
        return False

    def splits(self):
        """Per split: (step events, eval events, adaptation seconds, result)."""
        out, cur = [], {"step": [], "eval": [], "adapt": []}
        for kind, secs, delta, val in self.events:
            if kind == "split":
                out.append((cur["step"], cur["eval"], cur["adapt"], val))
                cur = {"step": [], "eval": [], "adapt": []}
            elif kind in cur:
                cur[kind].append((secs, delta, val))
        return out


def counted_kernels(torch, name, kernels, run):
    """run() counted (`launches_of`); fails unless each kernel of `kernels`
    launched and no other did. Returns the counts."""
    launches = launches_of(torch, name, run)
    wrong = {k: n for k, n in launches.items() if (n > 0) != (k in kernels)}
    if wrong:
        raise AssertionError(f"{name}: launches {wrong}, expected {sorted(kernels)} only")
    return launches


def phase_protocol(torch, rows):
    """The protocol and data layer on the card (module docstring, phase 6).
    Returns the launches of its drives."""
    t0 = time.perf_counter()
    root = tempfile.mkdtemp(prefix="kagnn_protocol_")
    try:
        drives = drive_flagship_protocol(torch, rows, root)
        drives += drive_protocol_drivers(torch, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    if os.path.exists(root):
        raise AssertionError(f"phase_protocol left {root}")
    log(f"protocol: phase done in {time.perf_counter() - t0:.1f} s")
    return drives


def drive_flagship_protocol(torch, rows, root):
    """Drive (a): ogbn-arxiv's layout written and parsed at full size, then
    run_node_experiment at the flagship widths through the probe, the
    reordered graph's kernels, a checkpoint resume, the least-squares solve
    and the B-spline kernels on adapted knots, and a sampled epoch. Returns
    the launches of run_node_experiment and of the sampled epoch."""
    from kagnn_tpu_torch.data import arxiv_scale_graph
    from kagnn_tpu_torch.data.planetoid import load_ogbn_arxiv
    from kagnn_tpu_torch.graphs import single_graph
    from kagnn_tpu_torch.kernels.selfcheck import check_spmm_split
    from kagnn_tpu_torch.train.experiments import run_node_experiment

    d0 = arxiv_scale_graph()
    t0 = time.perf_counter()
    write_ogbn_arxiv(root, d0)
    t_write = time.perf_counter() - t0
    t0 = time.perf_counter()
    d = load_ogbn_arxiv(root)
    t_load = time.perf_counter() - t0
    counts = [int(d[k][0].sum()) for k in ("train_masks", "val_masks", "test_masks")]
    log(f"protocol (a): ogbn-arxiv layout written in {t_write:.1f} s, parsed by "
        f"load_ogbn_arxiv in {t_load:.1f} s: {d['n_node']} nodes, "
        f"{d['senders'].shape[0]} edges after symmetrising "
        f"({d0['senders'].shape[0]} written), features {d['nodes'].shape}, "
        f"{d['num_classes']} classes, split {counts}")
    if (d["n_node"], tuple(counts), d["nodes"].shape[1]) != (d0["n_node"], ARXIV_SPLIT, 128) or \
            not np.array_equal(d["y"], d0["y"]) or \
            np.abs(d["nodes"] - d0["nodes"]).max() > 1e-6:
        raise AssertionError("protocol (a): the parsed ogbn-arxiv layout differs from the data written")

    per_epoch = {k: MAIN_PATHS[("gin", "kan")].get(k, 0) + FLAGSHIP_EVAL.get(k, 0)
                 for k in MAIN_PATHS[("gin", "kan")]}
    E = FLAGSHIP_PARAMS["epochs"]
    per_split = {k: n * E + FLAGSHIP_EVAL.get(k, 0) for k, n in per_epoch.items()}
    res = {}
    t0 = time.perf_counter()
    with ProtocolProbe(torch) as probe:
        launches = counted(torch, "protocol (a) run_node_experiment", per_split, lambda: res.update(
            summary=run_node_experiment(dict(FLAGSHIP_PARAMS), "ogbn-arxiv", data_root=root,
                                        log_dir=os.path.join(root, "logs"),
                                        max_splits=PROTOCOL_SPLITS, seed=0, device="cuda")),
            PROTOCOL_SPLITS)
    log(f"protocol (a): run_node_experiment {time.perf_counter() - t0:.1f} s "
        f"({PROTOCOL_SPLITS} splits, the dataset parsed again and reordered)")
    (reorder,) = [e for e in probe.events if e[0] == "reorder"]
    dr = reorder[3]
    hub_deg = np.bincount(dr["receivers"], minlength=dr["n_node"])
    log(f"protocol (a): reorder rcm {reorder[1]:.2f} s; the hub (in-degree "
        f"{hub_deg.max()}) now at row {int(hub_deg.argmax())}")
    for i, (steps, evals, adapts, result) in enumerate(probe.splits()):
        ms = [(s[0] + e[0]) * 1e3 for s, e in zip(steps, evals)]
        losses = [float(s[2]) for s in steps]
        bad = [j for j, (s, e) in enumerate(zip(steps, evals))
               if {k: s[1].get(k, 0) + e[1].get(k, 0) for k in per_epoch} != per_epoch]
        log(f"protocol (a) split {i}: ms per epoch (step + evaluation) "
            + ", ".join(f"{v:.2f}" for v in ms) + "; grid adaptations "
            + ", ".join(f"{s:.2f} s" for s, _, _ in adapts) + f"; train losses "
            + ", ".join(f"{v:.5f}" for v in losses) + f"; val_loss {result['val_loss']:.5f}, "
            f"accuracies train {result['train_acc']:.4f} val {result['val_acc']:.4f} "
            f"test {result['test_acc']:.4f}, epochs_run {result['epochs_run']}; "
            f"launches per epoch {per_epoch}")
        if bad or len(adapts) != (E - 1) // FLAGSHIP_PARAMS["update_grid"] or \
                not all(math.isfinite(v) for v in losses + [result["val_loss"]]) or \
                result["epochs_run"] != E:
            raise AssertionError(f"protocol (a) split {i}: epochs {bad} launched otherwise, "
                                 f"{len(adapts)} adaptations, losses {losses}, {result}")
    summary = res["summary"]
    with open(os.path.join(root, "logs", "ogbn-arxiv_kan_gin")) as fh:
        line = json.loads(fh.read())
    if line.keys() != {"params", "val_loss_mean", "test_acc_mean", "test_acc_std",
                       "test_accs"} or len(line["test_accs"]) != PROTOCOL_SPLITS:
        raise AssertionError(f"protocol (a): log line {line}")
    log(f"protocol (a): summary val_loss_mean {summary['val_loss_mean']:.5f}, "
        f"test_acc_mean {summary['test_acc_mean']:.4f}; log line keys {sorted(line)}")

    g = single_graph(dr["senders"], dr["receivers"], nodes=dr["nodes"], y=dr["y"],
                     device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(21)
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[1]
        close = lambda name, a, b, dn=dn: compare(  # noqa: E731
            torch, f"protocol reordered graph {name}", a, b, dn)
        record_row(rows["spmm"], check_spmm_split(g, 64, dtype, close, gen), False)
        record_row(rows["gin_fused"], check_gin_split(g, 128, 64, dtype, close, gen), False)
    protocol_epoch_busy(torch, g, d)
    protocol_checkpoint(torch, g, d)
    protocol_adapted_knots(torch, rows, g)
    return [launches, drive_sampled_epoch(torch, rows, dr, g)]


def flagship_model(torch, d, seed):
    from kagnn_tpu_torch.train.experiments import make_node_model

    params = dict(FLAGSHIP_PARAMS, mp_layers=3, num_classes=d["num_classes"],
                  num_features=d["nodes"].shape[1])
    return make_node_model(params, seed=seed, device="cuda")


def protocol_epoch_busy(torch, g, d, epochs=5):
    """The full-batch epoch of drive (a) as train_node_total runs it (a
    train step, an evaluation, the validation loss read on the host) on
    the reordered graph, unsynchronized between epochs: ms per epoch over
    `epochs` after one, then the busy share and top kernels over 3 profiled
    epochs."""
    from kagnn_tpu_torch.train import make_node_steps, masked_softmax_cross_entropy

    model = flagship_model(torch, d, 2)
    step, evaluate = make_node_steps(model, torch.optim.Adam(model.parameters(), lr=1e-3))
    pad = np.zeros(g.n_node_pad - d["n_node"], bool)
    train, val = (torch.from_numpy(np.concatenate([d[k][0], pad])).to("cuda")
                  for k in ("train_masks", "val_masks"))

    def epoch():
        step(g, train)
        return float(masked_softmax_cross_entropy(evaluate(g), g.y, val))

    epoch()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(epochs):
        epoch()
    ms = (time.perf_counter() - t0) * 1e3 / epochs
    log(f"protocol (a) epoch on the reordered graph: {ms:.3f} ms (step, evaluation, "
        f"validation loss read), unsynchronized between epochs")
    profile_steps(torch, epoch, ms)


def protocol_checkpoint(torch, g, d, k=3):
    """Drive (a)'s eager step (the flagship model on the reordered graph,
    Adam 1e-3): 2k steps uninterrupted against k steps, a save, a restore
    into a fresh model (other weights) and a fresh Adam, and k more; the
    losses must be equal bit for bit."""
    from kagnn_tpu_torch.train import checkpoint, make_node_steps

    mask = g.node_mask

    def fresh(seed):
        m = flagship_model(torch, d, seed)
        return m, torch.optim.Adam(m.parameters(), lr=1e-3)

    m, opt = fresh(0)
    step, _ = make_node_steps(m, opt)
    whole = torch.stack([step(g, mask) for _ in range(2 * k)])
    m, opt = fresh(0)
    step, _ = make_node_steps(m, opt)
    part = [step(g, mask) for _ in range(k)]
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "flagship.pt")
        t0 = time.perf_counter()
        checkpoint.save(path, m, opt, step=k)
        t_save = time.perf_counter() - t0
        m, opt = fresh(1)
        t0 = time.perf_counter()
        if checkpoint.restore(path, m, opt) != k:
            raise AssertionError("checkpoint: the step did not survive")
        t_restore = time.perf_counter() - t0
        size = os.path.getsize(path)
    step, _ = make_node_steps(m, opt)
    part = torch.stack(part + [step(g, mask) for _ in range(k)])
    same = torch.equal(whole, part)
    log(f"protocol (a) checkpoint: {size} B saved in {t_save:.3f} s, restored into a "
        f"fresh model and Adam in {t_restore:.3f} s; losses {whole.tolist()} "
        f"{'equal bit for bit to' if same else 'DIFFER from'} the resumed run's {part.tolist()}")
    if not same:
        raise AssertionError("checkpoint resume: the losses differ from the uninterrupted run")


def protocol_adapted_knots(torch, rows, g):
    """The card's least-squares solve against the CPU's gelsd (a
    rank-deficient system at the f32 bar; a grid refit on a batch of mostly
    zero rows by its residual) and the B-spline kernels on adapted knots
    (flagship widths, gin_fused over the reordered graph) and on knots whose
    narrowest span bf16 rounds to zero, in f32 and bf16."""
    from kagnn_tpu_torch.kan.bspline import b_splines, make_grid, update_grid
    from kagnn_tpu_torch.kernels.selfcheck import (adapted_knots, check_adapted_layer,
                                                   check_lstsq, degenerate_knots,
                                                   rank_deficient_system)

    A, B = rank_deficient_system()
    t0 = time.perf_counter()
    dev_ratio, err = check_lstsq(A, B, close=lambda n, a, b: compare(
        torch, f"protocol {n}", a, b, "float32"))
    gen = torch.Generator(device="cuda").manual_seed(22)
    x = torch.zeros(40_000, 64, device="cuda")
    x[:5_000] = torch.randn(5_000, 64, generator=gen, device="cuda")
    grid, _ = update_grid(x, make_grid(64, 8, 3, device="cuda"),
                          torch.randn(4, 64, 11, generator=gen, device="cuda"), None, 8, 3)
    A = b_splines(x, grid, 3).transpose(0, 1).contiguous()
    ratio, _ = check_lstsq(A, torch.randn(64, 40_000, 4, generator=gen, device="cuda"))
    log(f"protocol lstsq on the card against the CPU's gelsd: rank-deficient "
        f"(4, 2000, 7) coefficients max_abs_err {err:.3e}, residual ratio - 1 "
        f"{dev_ratio:.2e}; refit of a grid on 40,000 rows, 5,000 of them data "
        f"(the rest zero pad rows), (64, 40000, 11): residual ratio - 1 {ratio:.2e} "
        f"(bar 1e-6); "
        f"{time.perf_counter() - t0:.2f} s")
    knots = adapted_knots(64, 4, 3)
    log(f"protocol adapted knots, feature 0: {[round(v, 4) for v in knots[:, 0].tolist()]}")
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[1]
        close = lambda name, a, b, dn=dn: compare(  # noqa: E731
            torch, f"protocol {name}", a, b, dn)
        res = check_adapted_layer(20_000, 64, 64, knots, dtype, close, gen, g=g)
        deg = check_adapted_layer(128, 64, 40, degenerate_knots(knots), dtype, close, gen)
        for r, out in (("bspline_fwd", "fwd"), ("gin_fused", "gin")):
            record_row(rows[r], res[out][0], False)
        log(f"protocol knots bf16 rounds together, {dn}: " + ", ".join(
            f"{k} {v[1]} NaN {v[2]} inf (err of the finite {v[0]:.2e})" for k, v in deg.items())
            + " in the kernels and the plain versions alike")
        if (sum(v[1] + v[2] for v in deg.values()) > 0) != (dtype == torch.bfloat16):
            raise AssertionError("protocol degenerate knots: non-finite where not expected")


def drive_sampled_epoch(torch, rows, d, g):
    """One epoch of train_node_sampled (fanouts 10 and 5, batches of 512
    seeds) on the reordered data, with the launches counted: the sampler's
    host ms per batch alone and the step's ms alone first (20 batches of a
    separate sampler), and the kernels on the first sampled batch against
    their f64 sums. Returns the launches."""
    from kagnn_tpu_torch.data.sampling import NeighborSampler
    from kagnn_tpu_torch.kernels.selfcheck import check_spmm_split
    from kagnn_tpu_torch.train import make_node_steps
    from kagnn_tpu_torch.train.experiments import train_node_sampled

    masks = [torch.from_numpy(np.concatenate(
        [d[k][0], np.zeros(g.n_node_pad - d["n_node"], bool)])).to("cuda")
        for k in ("train_masks", "val_masks", "test_masks")]
    train = np.flatnonzero(d["train_masks"][0])
    sampler = NeighborSampler(d["senders"], d["receivers"], d["n_node"],
                              seed=5, device="cuda", **SAMPLED)
    it = sampler.epoch(train, d["nodes"], d["y"])
    t0 = time.perf_counter()
    batches = [b for _, b in zip(range(20), it)]
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / len(batches)
    b = batches[0]
    log(f"protocol sampled batch: {b.n_node} nodes of {b.n_node_pad}, {b.n_edge} "
        f"edges of {b.n_edge_pad} (the pad row takes {b.n_edge_pad - b.n_edge})")
    gen = torch.Generator(device="cuda").manual_seed(23)
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[1]
        close = lambda name, a, b_, dn=dn: compare(  # noqa: E731
            torch, f"protocol sampled batch {name}", a, b_, dn)
        record_row(rows["spmm"], check_spmm_split(b, 64, dtype, close, gen), False)
        record_row(rows["gin_fused"], check_gin_split(b, 128, 64, dtype, close, gen), False)
    model = flagship_model(torch, d, 3)
    step, _ = make_node_steps(model, torch.optim.Adam(model.parameters(), lr=1e-3))
    seed_mask = sampler.seed_mask()
    step(b, seed_mask)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for bb in batches:
        step(bb, seed_mask)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / len(batches)
    n_batches = len(train) // SAMPLED["batch_size"]
    per_run = {k: v * n_batches + 2 * FLAGSHIP_EVAL.get(k, 0)
               for k, v in MAIN_PATHS[("gin", "kan")].items()}
    res = {}
    model = flagship_model(torch, d, 4)
    t0 = time.perf_counter()
    launches = counted(torch, "protocol sampled epoch", per_run, lambda: res.update(
        r=train_node_sampled(model, d, g, dict(FLAGSHIP_PARAMS, epochs=1), *masks,
                             **SAMPLED)))
    secs = time.perf_counter() - t0
    r = res["r"]
    profile_steps(torch, lambda: step(b, seed_mask), secs * 1e3 / n_batches)
    log(f"protocol sampled epoch: {n_batches} batches in {secs:.1f} s "
        f"({secs * 1e3 / n_batches:.1f} ms a batch); the sampler alone "
        f"{host_ms:.1f} ms a batch on the host, the step alone {step_ms:.2f} ms; "
        f"val_loss {r['val_loss']:.5f}, test_acc {r['test_acc']:.4f}")
    if not math.isfinite(r["val_loss"]):
        raise AssertionError(f"protocol sampled epoch: {r}")
    return launches


def drive_protocol_drivers(torch, root):
    """Drives (b)-(d): the three experiment drivers' main() on data written
    in each format's layout, from a working directory under `root` (the
    graph drivers write logs/ there), with their launches counted and their
    logs checked against the JAX drivers' formats. Returns the launches."""
    from kagnn_tpu_torch.experiments import graph_classification as gc
    from kagnn_tpu_torch.experiments import graph_regression as gr
    from kagnn_tpu_torch.experiments import node_classification as nc

    for write in (write_planetoid_cora, write_tu_mutag, write_zinc):
        t0 = time.perf_counter()
        write(os.path.join(root, "data"))
        log(f"protocol: {write.__name__} {time.perf_counter() - t0:.1f} s")
    data = os.path.join(root, "data")
    trials = protocol_trials()
    common = ["--fused", "--bf16", "--n_trials", str(PROTOCOL_TRIALS), "--data_root", data]
    runs = {
        "b": (nc.main, ["--dataset", "Cora", "--architecture", "fastkan", "--conv_type",
                        "gcn", "--epochs", "3", "--max_splits", "1", "--log_dir", "logs"]),
        "c": (gc.main, ["--dataset", "MUTAG", "--model_type", "GAT", "--architecture",
                        "kan", "--n_outer_folds", "2", "--n_retrains", "1", "--epochs", "2"]),
        "d": (gr.main, ["--dataset", "ZINC", "--gnn-type", "GIN", "--model-type", "FASTKAN",
                        "--n_iterations", "1", "--epochs", "2"]),
    }
    cwd = os.getcwd()
    os.chdir(root)
    drives = []
    try:
        for key, (main, argv) in runs.items():
            res = {}
            t0 = time.perf_counter()
            drives.append(counted_kernels(torch, f"protocol ({key}) driver", DRIVER_KERNELS[key],
                                          lambda: res.update(out=main(argv + common))))
            log(f"protocol ({key}) driver: {time.perf_counter() - t0:.1f} s, trials "
                f"{trials[key]}, result {res['out']}")
        with open("logs/Cora_fastkan_gcn") as fh:
            lines = [json.loads(x) for x in fh]
        with open("logs/Cora_fastkan_gcn_finished") as fh:
            finished = json.loads(fh.read())
        with open("logs/KAN_MUTAG_GAT") as fh:
            gc_log = fh.read()
        with open("logs/ZINC_GIN_FASTKAN") as fh:
            gr_log = fh.read().splitlines()
    finally:
        os.chdir(cwd)
    ok = (len(lines) == PROTOCOL_TRIALS + 3
          and all(ln.keys() == {"params", "val_loss_mean", "test_acc_mean",
                                "test_acc_std", "test_accs"} for ln in lines)
          and finished.keys() == {"mean", "std", "best_params"}
          and gc_log.count("SPLIT ") == 2 and "\nAccuracies [" in gc_log
          and "\nParams [{'lr': " in gc_log and "\nSize [" in gc_log
          and gc_log.rstrip().splitlines()[-1].startswith("FINAL Mean: ")
          and gr_log[0].startswith("iter 0 best {'lr': ") and " test_mae " in gr_log[0]
          and ast.literal_eval(gr_log[-1][len("FINAL "):]).keys()
          == {"dataset", "test_mae_mean", "test_mae_std"})
    log(f"protocol drivers' logs: (b) {len(lines)} run lines and {finished}; (c) "
        f"{gc_log.splitlines()[-1]}; (d) {gr_log[-1]}: "
        f"{'the JAX drivers formats' if ok else 'NOT the JAX drivers formats'}")
    if not ok:
        raise AssertionError("protocol drivers: logs not in the JAX drivers' formats")
    return drives


# --- distribution (kagnn_tpu_torch/dist/) ------------------------------------

DIST_RANKS = 4  # the flagship's node shards: gloo ranks sharing cuda:0
DIST_WARMUP, DIST_TIMED = 2, 3
# (D, O) of the halo entries' checks: conv 0's and the later convs' first layer
HALO_ENTRY_SHAPES = ((128, 64), (64, 64))
HALO_ENTRY_SHARDS = (0, 2)  # shard 0 and an interior shard of the D=4 plan
# launches per step of each dist drive and rank (the others stay at 0):
# the halo flagship's are the single-card gin/kan step's (conv 0's input
# needs no gradient, so its dext is skipped); gcn/kan and gat/kan at one
# conv (f32, fused): the halo neighbor sum's two segment sums (internal,
# halo) on the kernel, the GAT softmax and sums plain; the edge partition
# gcn/kan at two convs: the neighbor sum's kernel both ways each conv; the
# DP step is G's
HALO_FLAGSHIP = MAIN_PATHS[("gin", "kan")]
HALO_SMALL = {"gcn": {"spmm": 2, "bspline_fwd": 2, "bspline_bwd": 2},
              "gat": {"bspline_fwd": 2, "bspline_bwd": 2}}
EDGE_PATH = {"spmm": 4, "bspline_fwd": 3, "bspline_bwd": 3}
DP_PATH = GRAPH_PATHS["G"]
DIST_STEPS = 2  # steps of the small halo, edge and DP drives


def dist_spec(torch, conv="gin", arch="kan", dtype="bfloat16", **kw):
    """A dist/runs.py node spec on the arxiv-sized graph (seed 0), the main
    path's widths, Adam(1e-3), fused, on the card."""
    model = dict(NODE_KW, conv_type=conv, architecture=arch, fused=True, dtype=dtype, seed=0)
    model.update(kw.pop("model", {}))
    return dict(dict(graph={"arxiv_seed": 0}, model=model, opt=("adam", 1e-3),
                     steps=DIST_WARMUP + DIST_TIMED, warmup=DIST_WARMUP,
                     strategy="halo", device="cuda"), **kw)


def scale_close(name, got, want, c, floor=0.0):
    """max |got - want| <= c * max |want| + floor (numpy arrays); logs the
    reading in units of the bar and raises past it."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = float(np.abs(got - want).max()) if got.size else 0.0
    bar = c * float(np.abs(want).max()) + floor if want.size else 1.0
    ok = err <= bar and math.isfinite(err)
    log(f"  {name}: max_abs_err={err:.3e} err/bar={err / bar if bar else 0.0:.3f} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: {err} > {bar}")
    return err


def grads_close(name, got, want, c, floor=0.0):
    if set(got) != set(want):
        raise AssertionError(f"{name}: gradient leaves differ")
    worst = max(float(np.abs(np.asarray(got[k], np.float64) - want[k]).max())
                / (c * float(np.abs(want[k]).max()) + floor + 1e-30) for k in want)
    log(f"  {name}: {len(want)} gradient leaves, worst err/bar={worst:.3f} "
        f"{'ok' if worst <= 1.0 else 'FAIL'}")
    if not worst <= 1.0:
        for k in want:
            scale_close(f"{name} {k}", got[k], want[k], c, floor)
    return worst


def same_params(name, ranks):
    if not all(np.array_equal(r["params"], ranks[0]["params"]) for r in ranks):
        raise AssertionError(f"{name}: the ranks' parameters differ")
    log(f"  {name}: parameters equal bit for bit on all {len(ranks)} ranks")


def log_rank_profile(name, r, step_ms):
    """A rank's profile of 3 steps (dist/runs.py `profile`): device ms a
    step and its share of the timed step, the largest kernels, host ms by
    operator."""
    p = r.get("profile")
    if not p or p["device_ms"] is None:
        log(f"  {name} profile: not measured (the profiler saw no device time)")
        return
    log(f"  {name} profile: {p['device_ms']:.3f} ms of kernels a step, busy share "
        f"{p['device_ms'] / step_ms:.3f} of {step_ms:.3f} ms; host {p['host_ms']:.3f} ms "
        f"of self CPU time a step under the profiler")
    for key, t, calls in p["kernels"]:
        log(f"    device {t:8.4f} ms/step {calls:4d} calls  {key[:80]}")
    for key, t, calls in p["host"]:
        log(f"    host   {t:8.4f} ms/step {calls:4d} calls  {key[:80]}")


def rank_launches(name, ranks, per_step, steps):
    """Every rank's launches are per_step * steps; returns their sum."""
    total = {}
    for r in ranks:
        check_launches(f"{name} rank {r['rank']}", r["launches"], per_step, steps)
        for k, n in r["launches"].items():
            total[k] = total.get(k, 0) + n
    log(f"  {name}: launches a step a rank "
        + ", ".join(f"{k} {n // steps}" for k, n in ranks[0]["launches"].items() if n))
    return total


def dist_plan_stats():
    """The D=4 halo plan of the arxiv-sized graph, as it comes and reordered
    by rcm (graphs/reorder.py): boundary rows, rows exchanged a rank and the
    shards' valid edges (host work only)."""
    from kagnn_tpu_torch.data import arxiv_scale_graph
    from kagnn_tpu_torch.dist.halo import build_halo_plan
    from kagnn_tpu_torch.graphs import single_graph
    from kagnn_tpu_torch.graphs.reorder import bfs_order, reorder_graph

    d = arxiv_scale_graph()
    for tag, dd in (("none", d), ("rcm", reorder_graph(dict(d), bfs_order))):
        t0 = time.perf_counter()
        g = single_graph(dd["senders"], dd["receivers"], n_node=int(dd["n_node"]), device="cpu")
        plan = build_halo_plan(g, DIST_RANKS)
        log(f"dist plan D={DIST_RANKS} reorder {tag}: block {plan.block}, halo H {plan.halo}, "
            f"boundary_rows {plan.boundary_rows}, comm_rows_per_device "
            f"{plan.comm_rows_per_device()}, extended rows {plan.block + plan.comm_rows_per_device()}, "
            f"valid edges by shard {[int(v) for v in plan.n_edge]}, e_loc {plan.e_loc} "
            f"({time.perf_counter() - t0:.1f} s)")


def dist_entries(torch, g, rows):
    """(a) both halo entries on shard 0 and an interior shard of the D=4
    plan of the arxiv-sized graph, at the main path's widths, f32 and bf16,
    fed an extended table directly (no process group), against their plain
    functions (`selfcheck.check_halo_entry`: forward, dz and the weight
    gradients with dw_walk_check, dx, dext against the f64 sender sum, twice
    bit for bit); the halo forward timed beside the single-card entry's over
    the whole graph."""
    from kagnn_tpu_torch.kernels import gin_fastkan as gfk
    from kagnn_tpu_torch.kernels import gin_fused as gf
    from kagnn_tpu_torch.kernels.selfcheck import check_halo_entry, halo_shard

    g_cpu = g.to("cpu")
    for shard in HALO_ENTRY_SHARDS:
        plan, gs, n_ext = halo_shard(g_cpu, DIST_RANKS, shard)
        log(f"halo entries, shard {shard} of {DIST_RANKS}: {gs.n_node_pad} rows, "
            f"{n_ext} extended rows, {gs.n_edge} valid of {gs.n_edge_pad} edges, "
            f"last row {'valid' if bool(gs.node_mask[-1]) else 'padding'}")
        for dn in ("float32", "bfloat16"):
            dt = getattr(torch, dn)
            for d, o in HALO_ENTRY_SHAPES:
                for kind, fused, bwd in (("kan", "gin_fused", "bspline_bwd"),
                                         ("fastkan", "gin_fastkan", "fastkan_bwd")):
                    gen = torch.Generator(device="cuda").manual_seed(shard * 1000 + d)
                    err = check_halo_entry(kind, gs, n_ext, d, o, dt,
                                           lambda n, a, b, dn=dn: compare(torch, n, a, b, dn),
                                           gen, wrong_must_fail=(dn == "bfloat16"), log=log,
                                           tag=f"shard {shard} {dn}")
                    for row, e in ((fused, err["forward"]), (bwd, err["layer_bwd"]),
                                   ("spmm", err["dext"])):
                        rows[row]["max_abs_err"] = max(rows[row]["max_abs_err"], e)
        # times: the halo forward on this shard against the single-card entry
        # over the whole graph, at conv 0's widths in bf16
        gen = torch.Generator(device="cuda").manual_seed(7)
        d, o = HALO_ENTRY_SHAPES[0]
        dt = torch.bfloat16
        ext = torch.randn((n_ext, d), generator=gen, device="cuda").to(dt)
        x = ext[:gs.n_node_pad].clone()
        xg = torch.randn((g.n_node_pad, d), generator=gen, device="cuda").to(dt)
        knots = make_grid_knots(torch, d, dt)
        wb = (torch.randn((d, o), generator=gen, device="cuda") * 0.3).to(dt)
        ws = (torch.randn((7 * d, o), generator=gen, device="cuda") * 0.3).to(dt)
        lw = tuple(t.to(dt) for t in (1.0 + 0.2 * torch.randn((d,), generator=gen, device="cuda"),
                                       0.1 * torch.randn((d,), generator=gen, device="cuda"),
                                       0.3 * torch.randn((4 * d, o), generator=gen, device="cuda"),
                                       0.3 * torch.randn((d, o), generator=gen, device="cuda"),
                                       0.1 * torch.randn((o,), generator=gen, device="cuda")))
        for row, halo, single, plain in (
                ("gin_fused",
                 lambda: gf.gin_kan_fwd(x, gs.senders, gs.recv_row_ptr, knots, wb, ws, 3, 0.0, ext=ext),
                 lambda: gf.gin_kan_fwd(xg, g.senders, g.recv_row_ptr, knots, wb, ws, 3, 0.0),
                 lambda: gf.gin_kan_fwd_plain(x, gs.senders, gs.recv_row_ptr, knots, wb, ws, 3,
                                              0.0, ext=ext)),
                ("gin_fastkan",
                 lambda: gfk.gin_fastkan_fwd(x, gs.senders, gs.recv_row_ptr, *lw, 0.0, -2.0, 2.0,
                                             ext=ext),
                 lambda: gfk.gin_fastkan_fwd(xg, g.senders, g.recv_row_ptr, *lw, 0.0, -2.0, 2.0),
                 lambda: gfk.gin_fastkan_fwd_plain(x, gs.senders, gs.recv_row_ptr, *lw, 0.0,
                                                   -2.0, 2.0, ext=ext))):
            log(f"  {row} halo entry shard {shard} bf16 D={d} O={o}: "
                f"{time_ms(halo):.4f} ms (plain {time_ms(plain):.4f} ms); single-card entry "
                f"over the whole graph {time_ms(single):.4f} ms")


def make_grid_knots(torch, d, dt):
    from kagnn_tpu_torch.kan.bspline import make_grid

    return make_grid(d, 4, 3, device="cuda").t().contiguous().to(dt)


def dist_halo_drives(torch, rows):
    """(b) the halo flagship step on DIST_RANKS gloo ranks sharing cuda:0
    (full width, bf16, 2 warm-up + 3 timed steps) against the single-card
    step from the same weights, and in f32 (1 warm-up + 1 timed step)
    against the f32 single-card step at the f32 step bars; (c) the gin/fastkan halo fusion point and the
    gcn/kan and gat/kan halo steps at one conv (f32) against their
    single-card drives; and what gloo does with tensors on the card. One
    spawn for all of them. Returns the launches."""
    from kagnn_tpu_torch.dist import runs
    from kagnn_tpu_torch.dist.launch import launch

    flag = dist_spec(torch, profile=True)
    flag32 = dist_spec(torch, dtype="float32", steps=2, warmup=1)
    small = {c: dist_spec(torch, c, "kan", "float32", steps=DIST_STEPS, warmup=0,
                          model=dict(mp_layers=1)) for c in HALO_SMALL}
    fusion = dict(graph={"arxiv_seed": 0}, widths=[NODE_KW["num_features"],
                  NODE_KW["hidden_channels"], NODE_KW["hidden_channels"]],
                  num_grids=NODE_KW["grid_size"], dtype="float32", device="cuda")
    jobs = ([("node", flag), ("node", flag32), ("fusion", fusion)]
            + [("node", small[c]) for c in HALO_SMALL]
            + [("gloo_probe", {})])
    t0 = time.perf_counter()
    res = launch(runs.many_rank, DIST_RANKS, (jobs,), backend="gloo", device="cuda",
                 timeout=900)
    log(f"dist halo drives: {DIST_RANKS} gloo ranks on cuda:0 (they share one card: "
        f"their times measure the partition's cost, not scaling), "
        f"{time.perf_counter() - t0:.1f} s with start-up")
    log(f"  gloo with tensors on the card: {res[0][-1]}; the port hands them to "
        f"gloo where they are")
    total = {}

    def add(launches):
        for k, n in launches.items():
            total[k] = total.get(k, 0) + n

    # (b) the flagship
    ranks = [r[0] for r in res]
    r0 = ranks[0]
    log(f"halo flagship (gin/kan fused bf16, D={DIST_RANKS}): block {r0['block']}, H {r0['halo']}, "
        f"boundary_rows {r0['boundary_rows']}, comm_rows_per_device {r0['comm_rows_per_device']}, "
        f"valid edges by shard {r0['shard_edges']}")
    for r in ranks:
        log(f"  rank {r['rank']}: ms/step {r['ms']:.3f} (ranks sharing one card), "
            f"peak_mem {r['peak_gib']:.3f} GiB, losses {['%.6f' % v for v in r['losses']]}")
    add(rank_launches("halo flagship", ranks, HALO_FLAGSHIP, DIST_WARMUP + DIST_TIMED))
    same_params("halo flagship", ranks)
    log_rank_profile("halo flagship rank 0", r0, r0["ms"])
    single = runs.node_single(flag, "cuda")
    exact = runs.node_single(dict(flag, model=dict(flag["model"], dtype="float32"),
                                  steps=1, warmup=0), "cuda")
    log(f"  single-card flagship step: ms/step {single['ms']:.3f}, losses "
        f"{['%.6f' % v for v in single['losses']]}")
    for i, (a, b) in enumerate(zip(r0["losses"], single["losses"])):
        scale_close(f"halo flagship loss {i}", a, b, 4 * BF16_ULP)
    nm = np.asarray(main_graph_mask(single["n_node_pad"]))
    from kagnn_tpu_torch.dist.runs import stitch_logits
    scale_close("halo flagship logits", stitch_logits(ranks, single["n_node_pad"])[nm],
                single["logits"][nm], 4 * BF16_ULP)
    # the gradients: each leaf of the halo step no farther from the f32
    # single-card step's than the bf16 single-card step's is, plus the step
    # bar of 8 bf16 ulps of the leaf's scale. Against the bf16 single-card
    # gradients alone 8 ulps cannot hold: its weight gradients walk 1,323
    # bf16 row tiles, each shard's 331, and the single-card walk reads up to
    # 111 ulps from f32 where the halo's reads 38 (NVIDIA H100 80GB HBM3,
    # 700 W; PERF.md §6)
    plain_worst, worst, bad = 0.0, 0.0, []
    for k, v in single["grads"].items():
        u = BF16_ULP * float(np.abs(v).max()) + 1e-30
        got, ex = r0["grads"][k], exact["grads"][k]
        plain = float(np.abs(got - v).max()) / u
        halo_off, single_off = (float(np.abs(got - ex).max()) / u,
                                float(np.abs(v - ex).max()) / u)
        ratio = halo_off / (single_off + 8.0)
        plain_worst, worst = max(plain_worst, plain), max(worst, ratio)
        log(f"    {k}: {plain:.2f} ulps from the single-card bf16 step; from the f32 "
            f"step: halo {halo_off:.2f}, single-card {single_off:.2f} ulps; bar {ratio:.3f}")
        if not ratio <= 1.0:
            bad.append(k)
    log(f"  halo flagship gradients: {len(single['grads'])} leaves, worst "
        f"{plain_worst:.2f} bf16 ulps of the leaf's scale from the single-card bf16 "
        f"step; no farther from the f32 step than it, plus 8 ulps: worst {worst:.3f} "
        f"of the bar {'ok' if not bad else 'FAIL'}")
    if bad:
        FAILED.append(f"halo flagship gradients past the bar: {bad}")
    # (b) in f32: the same step against the f32 single-card step (`exact`,
    # its first step) at the f32 step bars, every gradient leaf
    ranks = [r[1] for r in res]
    add(rank_launches("halo flagship f32", ranks, HALO_FLAGSHIP, 2))
    try:
        same_params("halo flagship f32", ranks)
        scale_close("halo flagship f32 loss 0", ranks[0]["losses"][0], exact["losses"][0], 1e-4)
        scale_close("halo flagship f32 logits", stitch_logits(ranks, exact["n_node_pad"])[nm],
                    exact["logits"][nm], 1e-4, 1e-5)
        worst32 = grads_close("halo flagship f32", ranks[0]["grads"], exact["grads"], 1e-3, 1e-5)
        log(f"  halo flagship f32: ms/step {ranks[0]['ms']:.3f} (ranks sharing one card; "
            f"the single-card f32 first step {exact['ms']:.3f} ms); worst gradient leaf "
            f"{worst32:.3f} of the f32 bar")
    except AssertionError as e:
        FAILED.append(f"halo flagship f32: {e}")
    # (c) the fusion point and the small halo steps
    fres = [r[2] for r in res]
    fref = runs.fusion_single(fusion, "cuda")
    add(rank_launches("halo fusion point", fres, FUSION_POINT, 1))
    nmf = np.asarray(main_graph_mask(fref["n_node_pad"]))
    stitch = np.concatenate([r["out"] for r in fres])[:fref["n_node_pad"]]
    scale_close("halo fusion point out", stitch[nmf], fref["out"][nmf], 1e-4)
    scale_close("halo fusion point dx", np.concatenate([r["dx"] for r in fres])[:fref["n_node_pad"]],
                fref["dx"], 1e-3, 1e-5)
    grads_close("halo fusion point", fres[0]["dw"], fref["dw"], 1e-3, 1e-5)
    for j, conv in enumerate(HALO_SMALL):
        ranks = [r[3 + j] for r in res]
        ref = runs.node_single(small[conv], "cuda")
        add(rank_launches(f"halo {conv}/kan", ranks, HALO_SMALL[conv], DIST_STEPS))
        for i, (a, b) in enumerate(zip(ranks[0]["losses"], ref["losses"])):
            scale_close(f"halo {conv}/kan loss {i}", a, b, 1e-4)
        grads_close(f"halo {conv}/kan", ranks[0]["grads"], ref["grads"], 1e-3, 1e-5)
        same_params(f"halo {conv}/kan", ranks)
        log(f"  halo {conv}/kan one conv f32: ms/step {ranks[0]['ms']:.3f} (shared card), "
            f"single-card {ref['ms']:.3f}")
    return total


_MASK = {}


def main_graph_mask(n_pad):
    """The arxiv-sized graph's valid rows (169,343 of n_pad)."""
    if n_pad not in _MASK:
        _MASK[n_pad] = np.arange(n_pad) < 169_343
    return _MASK[n_pad]


def dist_edge_dp(torch):
    """(d) the edge-partitioned step (gcn/kan, two convs, f32, fused) and the
    DP graph-classification step (G's model, gin/kan bf16, batches of 256
    molecules a replica) on 2 gloo ranks sharing cuda:0, against their
    single-card counterparts. Returns the launches."""
    from kagnn_tpu_torch.dist import runs
    from kagnn_tpu_torch.dist.launch import launch

    edge = dist_spec(torch, "gcn", "kan", "float32", strategy="edge", steps=DIST_STEPS,
                     warmup=0, model=dict(mp_layers=2))
    dp = dict(batch=GRAPH_BATCH, replicas=2, seed=3, opt=("adam", 1e-3), steps=DIST_STEPS,
              device="cuda", mesh=(2, 1),
              model=dict(conv_type="gin", architecture="kan", gnn_layers=3, num_features=21,
                         hidden_dim=64, num_classes=2, hidden_layers=2, grid_size=4,
                         spline_order=3, fused=True, dtype="bfloat16", seed=0))
    res = launch(runs.many_rank, 2, ([("node", edge), ("dp", dp)],), backend="gloo",
                 device="cuda", timeout=600)
    total = {}
    ranks = [r[0] for r in res]
    ref = runs.node_single(edge, "cuda")
    for k, n in rank_launches("edge partition gcn/kan", ranks, EDGE_PATH, DIST_STEPS).items():
        total[k] = total.get(k, 0) + n
    for i, (a, b) in enumerate(zip(ranks[0]["losses"], ref["losses"])):
        scale_close(f"edge partition loss {i}", a, b, 1e-4)
    grads_close("edge partition", ranks[0]["grads"], ref["grads"], 1e-3, 1e-5)
    same_params("edge partition", ranks)
    log(f"  edge partition gcn/kan 2 convs f32: ms/step {ranks[0]['ms']:.3f} "
        f"(2 ranks sharing one card), single-card {ref['ms']:.3f}")
    ranks = [r[1] for r in res]
    ref = runs.dp_single(dict(dp, steps=1), "cuda")
    for k, n in rank_launches("DP graph classification", ranks, DP_PATH, DIST_STEPS).items():
        total[k] = total.get(k, 0) + n
    scale_close("DP loss", ranks[0]["losses"][0], ref["loss"], 4 * BF16_ULP)
    grads_close("DP", ranks[0]["grads"], ref["grads"], 8 * BF16_ULP)
    grads_close("DP running statistics", ranks[0]["stats"], ref["stats"], 4 * BF16_ULP)
    same_params("DP", ranks)
    log(f"  DP G 2 replicas of {GRAPH_BATCH}: ms/step {ranks[0]['ms']:.3f} (2 ranks sharing one card)")
    return total


def dist_nccl(torch):
    """(e) one nccl rank: the halo flagship with force_full=True (the whole
    machinery over a one-rank group: all_to_all_single and all_reduce on
    the card through NCCL) against the one-shard specialisation (no
    exchange, no collective), both in the rank's process, in turns.
    Returns the launches."""
    from kagnn_tpu_torch.dist import runs
    from kagnn_tpu_torch.dist.launch import launch

    full = dist_spec(torch, force_full=True, profile=True)
    single = dist_spec(torch, profile=True)
    # in the rank's process, in turns: force_full, the specialisation, again
    res = launch(runs.many_rank, 1, ([("node", full), ("node", single)] * 2,),
                 backend="nccl", device="cuda", timeout=600)
    fulls, singles = res[0][0::2], res[0][1::2]
    log_rank_profile("nccl force_full", fulls[1], fulls[1]["ms"])
    log_rank_profile("one-shard specialisation", singles[1], singles[1]["ms"])
    for r in fulls:
        rank_launches("nccl force_full", [r], HALO_FLAGSHIP, DIST_WARMUP + DIST_TIMED)
    ref = singles[0]
    for r in fulls:
        for i, (a, b) in enumerate(zip(r["losses"], ref["losses"])):
            scale_close(f"nccl force_full loss {i}", a, b, 4 * BF16_ULP)
        grads_close("nccl force_full", r["grads"], ref["grads"], 8 * BF16_ULP)
    bits = all(r["losses"] == ref["losses"] and all(
        np.array_equal(r["grads"][k], ref["grads"][k]) for k in ref["grads"]) for r in fulls)
    log(f"  nccl rank: force_full ms/step {fulls[0]['ms']:.3f}, {fulls[1]['ms']:.3f}; the "
        f"one-shard specialisation {singles[0]['ms']:.3f}, {singles[1]['ms']:.3f} (in turns, "
        f"one process); peak_mem {fulls[0]['peak_gib']:.3f} / {singles[0]['peak_gib']:.3f} GiB; "
        f"tax {np.mean([r['ms'] for r in fulls]) - np.mean([r['ms'] for r in singles]):.3f} "
        f"ms/step; losses and gradients "
        f"{'equal bit for bit' if bits else 'within the bars, not bit for bit'}")
    return {k: sum(r["launches"][k] for r in res[0]) for k in fulls[0]["launches"]}


def dist_scaling_driver():
    """`python -m kagnn_tpu_torch.experiments.scaling`'s main() at its
    defaults (20,000 nodes, 200,000 edges, gin/kan f32), fused, on 1 and
    DIST_RANKS gloo ranks sharing cuda:0: its JSON rows."""
    from kagnn_tpu_torch.experiments import scaling

    t0 = time.perf_counter()
    rows = scaling.main(["--devices", "1", str(DIST_RANKS), "--backend", "gloo",
                         "--device", "cuda", "--iters", "3", "--fused"])
    if [r["n_devices"] for r in rows] != [1, DIST_RANKS] or not all(
            math.isfinite(r["loss"]) for r in rows):
        raise AssertionError(f"scaling driver rows: {rows}")
    log(f"scaling driver (gloo ranks sharing one card: the partition's cost, not "
        f"scaling): {len(rows)} rows in {time.perf_counter() - t0:.1f} s")


FAILED = []  # checks of the dist phase that failed, raised at its end


def phase_dist(torch, g, rows):
    """The distribution phase: (a) the halo entries against their plain
    functions, (b)-(c) the halo drives, (d) the edge partition and DP,
    (e) one nccl rank; the plan's statistics with and without rcm, and the
    scaling driver. Returns the launches of (b)-(e), summed over the
    ranks."""
    import traceback

    def attempt(name, fn, *args):
        """fn(*args), its failure logged and kept for the phase's end, so
        that every drive runs and reports in one call."""
        try:
            return fn(*args)
        except Exception as e:  # noqa: BLE001 - re-raised at the phase's end
            log(traceback.format_exc())
            FAILED.append(f"{name}: {type(e).__name__}: {e}")
            return {}

    t0 = time.perf_counter()
    dist_plan_stats()
    attempt("halo entries", dist_entries, torch, g, rows)
    drives = [attempt("halo drives", dist_halo_drives, torch, rows),
              attempt("edge partition and DP", dist_edge_dp, torch),
              attempt("nccl force_full", dist_nccl, torch)]
    attempt("scaling driver", dist_scaling_driver)
    log(f"dist phase: {time.perf_counter() - t0:.1f} s")
    if FAILED:
        raise AssertionError("dist phase: " + "; ".join(FAILED))
    return drives


def phase_kernel_report():
    """utils/profiling.kernel_report() at its defaults, one JSON line a row."""
    from kagnn_tpu_torch.utils.profiling import kernel_report

    log("kernel_report (n=131072, d=64, o=64, f32, forward):")
    for row in kernel_report():
        log("  " + json.dumps(row))


def main() -> int:
    import torch

    card = phase_device(torch)
    phase_build()
    g = main_graph(torch)
    log("kernels against their plain versions:")
    rows = phase_kernels(torch, g)
    log("kernels at the search-space corners against their plain versions:")
    phase_corners(torch, rows)
    for conv, arch in MAIN_PATHS:
        phase_small_step(torch, conv, arch)
    for conv, arch, corner in STEP_CORNERS:
        phase_small_step(torch, conv, arch, **corner)
    phase_small_fastkan(torch)
    phase_small_graph_steps(torch)
    step_ms, drives, profiled = {}, [], []
    for conv, arch in MAIN_PATHS:
        launches, step_ms[f"{conv}/{arch}"], by_kernel = phase_main_path(torch, g, conv, arch)
        drives.append(launches)
        profiled.append((launches, by_kernel))
    launches, step_ms["fastkan/base-free"], by_kernel = phase_fastkan_path(torch, g)
    profiled.append((launches, by_kernel))
    captured_ms = {name: phase_captured(torch, g, name, per_step) for name, per_step in
                   [(f"{c}/{a}", p) for (c, a), p in MAIN_PATHS.items()]
                   + [("fastkan/base-free", FASTKAN_PATH)]}
    drives += [launches, phase_fusion_point(torch, g), phase_ln_free_layer(torch, g),
               phase_narrow_drive(torch, g)]
    for task in GRAPH_PATHS:
        launches, ms, by_kernel = phase_graph_path(torch, task, rows)
        step_ms.update({f"graph {task} {k}": v for k, v in ms.items()})
        drives.append(launches)
        profiled.append((launches, by_kernel))
    drives += phase_protocol(torch, rows)
    drives += phase_dist(torch, g, rows)
    for launches in drives:
        for name, n in launches.items():
            rows[name]["launches"] += n
    phase_kernel_report()
    unused = [n for n, r in rows.items() if r["launches"] == 0]
    if unused:
        raise AssertionError(f"kernels no main path launched: {unused}")
    log(f"card: {card}; main paths ms/step: "
        + ", ".join(f"{k}={v:.3f}" for k, v in step_ms.items()))
    log(f"card: {card}; captured against eager ms/step (Adam capturable): "
        + ", ".join(f"{k}={c:.3f}/{e:.3f}" for k, (c, e) in captured_ms.items()))
    # the order in which to redesign the kernels: first those slower than
    # one PyTorch call of the same function, by the factor; then the rest by
    # the profiled device ms per step of their kernels, summed over the
    # twelve paths (the ten node paths and the two graph paths; every shape
    # a path launches counts at its own time)
    slower = sorted((r for r in rows.values()
                     if r["library_ms"] is not None and r["ms"] > r["library_ms"]),
                    key=lambda r: -r["ms"] / r["library_ms"])
    log("slower than the library call: " + (", ".join(
        f"{r['name']} {r['ms'] / r['library_ms']:.2f}x" for r in slower) or "none"))
    per_step = dict.fromkeys(rows, 0.0)
    other = 0.0
    for launches, by_kernel in profiled:
        for key, t in by_kernel.items():
            row = kernel_row_of(key, launches)
            if row is None and kernel_base_name(key).startswith(("gat", "gin")):
                raise AssertionError(f"a profiled GAT or GIN kernel found no row: {key}")
            if row is None:
                other += t
            else:
                per_step[row] += t
    if any(by_kernel for _, by_kernel in profiled):
        log("redesign order, device ms per step by kernel summed over the twelve "
            "paths (profiler): " + ", ".join(
                f"{k} {v:.3f}" for k, v in sorted(per_step.items(), key=lambda kv: -kv[1]))
            + f"; PyTorch's own kernels {other:.3f}")
    else:
        log("redesign order: not measured (the profiler saw no device time)")
    print(json.dumps({"kernels": list(rows.values())}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
