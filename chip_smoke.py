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
     widths with x/w in f32/f32, f32/bf16 and bf16/bf16; the narrow sum at
     k = 4 over the arxiv-sized graph's receivers; spmm also over the
     receiver CSR with idx = senders at the gin/fastkan step's widths, timed
     beside torch.sparse.mm and on its hub row alone and its light rows
     alone, and on a graph whose both CSRs hold heavy rows, at 1-300
     columns, bit for bit twice; gin_fused, which splits receiver rows of
     more than 64 edges, on that graph at 7-300 columns, bit for bit twice,
     with the kernels it launches by dtype, and on the main graph's hub row
     alone and light rows alone, timed; gcn_agg also on a hub row
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
     also at 1, 7, 40 and 512 outputs, the RBF backward at 2,048) against
     its plain version;
  4. whole step, small graph, per node path (gin/kan, gcn/kan,
     gcn/fastkan, gin/fastkan, gat/kan, gat/fastkan), at five search-space
     corners (STEP_CORNERS) and for the base-free FastKAN and the
     layernorm-free FastKANLayer: the kernel path (fused=True) and the plain
     path (fused=False) agree on logits and every parameter gradient;
  5. main paths: the bf16 train step of each node path at full width on
     the arxiv-sized synthetic graph (169,343 nodes, 1,166,243 edges), and
     of FastKAN([128, 64, 64, 40], num_grids=8, use_base_update=False) on
     its node rows, 2 warm-up + 10 timed steps each, with the launch
     counters set to 0 before and checked after each path, and a profiler
     breakdown (which keys the redesign order: device ms per step by
     kernel, summed over the paths); then three drives of kernels no path launches, each forward
     and backward once with its counts checked the same way: the
     GIN+FastKAN fusion point `FastKAN(x, gin_graph=(g, 0))` (the GIN conv
     sums z itself for a FastKAN net, as the JAX model does), the
     layernorm-free FastKANLayer(128, 64) in bf16 (the RBF product of a
     bf16 basis) and the narrow segment sum (no caller, as in the JAX
     package); then `utils/profiling.kernel_report()` at its defaults;
  6. prints the kernel list as one JSON line, then the result line.

It imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time

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
                                               check_gat_split, check_gin_split,
                                               dw_walk_check, gin_fused_expected,
                                               profiled_kernels)

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


def phase_build():
    from kagnn_tpu_torch.kernels import _build

    units = list(_build.MAIN)
    units += [(n, s) for n in ("bspline_fused", "gin_fused") for s in KAN_CORNERS]
    units += [(n, (g,)) for n in ("fastkan_layer", "gin_fastkan", "rbf_fused")
              for g in FASTKAN_CORNERS]
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


def log_gin_parts(torch, g, ga, dn, D, O):
    """gin_fused on the main graph: the kernels it launches for its dtype
    (the phase fails otherwise), each profiled kernel on the gin_fused row of
    the kernel table, and the call's time over the receiver CSR's longest row
    alone and its light rows alone (every other row empty), with the split
    aggregate's kernels profiled there: its hub row is theirs alone."""
    from kagnn_tpu_torch.kernels import gin_fused as gf

    x = ga[0]
    want = gin_fused_expected(x)
    names = profiled_kernels(lambda: gf.gin_kan_fwd(*ga), want)
    log(f"  gin_fused main {dn} D={D} O={O} kernels: {', '.join(sorted(names))}")
    if names != want:
        raise AssertionError(f"gin_fused {dn}: launched {names}, expected {want}")
    log_kernel_split(torch, f"gin_fused main {dn} D={D} O={O}",
                     lambda: gf.gin_kan_fwd(*ga), row="gin_fused")
    hub_idx, hub_ptr, d_hub, hub = hub_row_alone(g)
    for part, (idx, rp) in ((f"hub row alone (node {hub}, in-degree {d_hub})",
                             (hub_idx, hub_ptr)),
                            ("light rows alone", light_rows_alone(g)[:2])):
        args = (x, idx, rp, *ga[3:])
        ms = time_ms(lambda: gf.gin_kan_fwd(*args))
        log(f"  gin_fused {part} {dn} D={D} O={O}: {ms:.4f} ms")
        log_kernel_split(torch, f"gin_fused {part} {dn} D={D} O={O}",
                         lambda: gf.gin_kan_fwd(*args))


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
                    log_gin_parts(torch, g, ga, dn, D, O)
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


def phase_gin_split(torch, rows):
    """gin_fused on spmm_split_graph (a 2,748-edge receiver row, rows of
    63-65, the pad row heavy by its padding), out and z of every row against
    its plain version at GIN_SPLIT_WIDTHS and GIN_SPLIT_SHAPES, in f32 and
    bf16, twice and equal bit for bit (`selfcheck.check_gin_split`)."""
    from kagnn_tpu_torch.kernels.selfcheck import spmm_split_graph

    gen = torch.Generator(device="cuda").manual_seed(12)
    sg = spmm_split_graph()
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[1]
        for shape in GIN_SPLIT_SHAPES:
            for D in GIN_SPLIT_WIDTHS:
                record_row(rows["gin_fused"], check_gin_split(
                    sg, D, 64, dtype, lambda name, a, b: compare(torch, name, a, b, dn), gen,
                    shape), False)


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
                errg = max((compare(torch, f"gin_fastkan {gname} D={D} O={O} {w}",
                                    a[nm], b[nm], dn)
                            for w, a, b in zip(("out", "z"),
                                               gfk.gin_fastkan_fwd(*ga_args),
                                               gfk.gin_fastkan_fwd_plain(*ga_args))),
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
                    if name == "rbf_bwd":
                        check_rbf_bwd_route(torch, f"rbf_bwd main {xn}/{wn} D={D} O={O}",
                                            x, w, dout, ops)
                    record_row(rows[name], e, rep, ms=ms, plain_ms=pms,
                               bound_ms=bms, bound_by=by, library_ms=None)

    # the narrow sum: k = 4 over the main graph's receivers (a 4-head GAT's
    # per-edge quantities), and k in 1..8 on the small and ragged graphs
    rng = np.random.default_rng(3)
    small_rcv = torch.from_numpy(np.sort(rng.integers(0, 110, 700)).astype(
        np.int32)).to("cuda")  # 10 past the 100 segments
    for dn in ("float32", "bfloat16"):
        dt = getattr(torch, dn)
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
                ms = time_ms(lambda: spmm.sorted_segment_sum_narrow(*args))
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
                log(f"  spmm_narrow main {dn} k={k}: ms={ms:.4f} plain_ms={pms:.4f} "
                    f"library_ms={'none' if lms is None else f'{lms:.4f}'} "
                    f"bound_ms={bms:.4f} ({by})")
                record_row(rows["spmm_narrow"], err, dn == "float32", ms=ms,
                           plain_ms=pms, bound_ms=bms, bound_by=by,
                           library_ms=lms)


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
        if dtype == torch.bfloat16:  # the backward's output parts
            shapes += [(4, 16, 32, 512), (3, 4, 64, 512)]
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
                               gfk.gin_fastkan_fwd_plain(*ga)):
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


def counters():
    """Every kernel wrapper with its launch counter, by kernel name."""
    from kagnn_tpu_torch.kernels import bspline_fused as bf
    from kagnn_tpu_torch.kernels import fastkan_layer as fk
    from kagnn_tpu_torch.kernels import gat_bwd as gbw
    from kagnn_tpu_torch.kernels import gat_fused as gfu
    from kagnn_tpu_torch.kernels import gcn_agg as ga
    from kagnn_tpu_torch.kernels import gin_fastkan as gfk
    from kagnn_tpu_torch.kernels import gin_fused as gf
    from kagnn_tpu_torch.kernels import rbf_fused as rf
    from kagnn_tpu_torch.kernels import spmm

    return {"spmm": spmm.sorted_segment_sum, "bspline_fwd": bf.kan_linear_fwd,
            "bspline_bwd": bf.kan_linear_bwd, "gin_fused": gf.gin_kan_fwd,
            "gcn_agg": ga.gcn_agg_fwd, "fastkan_fwd": fk.fastkan_layer_fwd,
            "fastkan_bwd": fk.fastkan_layer_bwd,
            "gin_fastkan": gfk.gin_fastkan_fwd, "gat_fwd": gfu.gat_fwd,
            "gat_dadst": gbw.gat_dadst, "gat_sender": gbw.gat_sender,
            "rbf_fwd": rf.rbf_spline_fwd, "rbf_bwd": rf.rbf_spline_bwd,
            "spmm_narrow": spmm.sorted_segment_sum_narrow}


def check_launches(name, launches, per_run, runs=1):
    """Every kernel launched exactly per_run[k] * runs times (0 if absent)."""
    for k, n in launches.items():
        if n != per_run.get(k, 0) * runs:
            raise AssertionError(f"{name}: {k} launched {n} times in {runs} "
                                 f"runs, expected {per_run.get(k, 0)} per run")


def phase_main_path(torch, g, conv, arch):
    from kagnn_tpu_torch.models import NodeClassifier

    model = NodeClassifier(conv_type=conv, architecture=arch, fused=True,
                           compute_dtype=torch.bfloat16, seed=0,
                           device="cuda", **NODE_KW)
    return drive_path(torch, g, f"{conv}/{arch}", model, MAIN_PATHS[(conv, arch)])


def phase_fastkan_path(torch, g):
    """The slice's path at full width: the reference fastkan's layers with
    use_base_update=False trained full-batch on the node features."""
    from kagnn_tpu_torch.kan import FastKAN

    class OnNodes(torch.nn.Module):
        """The net on the graph's node rows (the calling convention of
        make_node_steps)."""

        def __init__(self, net):
            super().__init__()
            self.net = net

        def forward(self, batch):
            return self.net(batch.nodes)

    net = FastKAN([NODE_KW["num_features"], NODE_KW["hidden_channels"],
                   NODE_KW["hidden_channels"], NODE_KW["num_classes"]],
                  num_grids=RBF_G, use_base_update=False, fused=True,
                  compute_dtype=torch.bfloat16, device="cuda")
    return drive_path(torch, g, "fastkan/base-free", OnNodes(net), FASTKAN_PATH)


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


def counted(torch, name, per_run, run, runs=1):
    """run() with every launch counter set to 0 just before and read just
    after; checks the counts against per_run * runs and returns them."""
    fns = counters()
    torch.cuda.synchronize()
    for f in fns.values():
        f.launches = 0
    run()
    torch.cuda.synchronize()
    launches = {k: f.launches for k, f in fns.items()}
    log(f"{name} launches: {launches}")
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
    step_ms, drives, profiled = {}, [], []
    for conv, arch in MAIN_PATHS:
        launches, step_ms[f"{conv}/{arch}"], by_kernel = phase_main_path(torch, g, conv, arch)
        drives.append(launches)
        profiled.append((launches, by_kernel))
    launches, step_ms["fastkan/base-free"], by_kernel = phase_fastkan_path(torch, g)
    profiled.append((launches, by_kernel))
    drives += [launches, phase_fusion_point(torch, g), phase_ln_free_layer(torch, g),
               phase_narrow_drive(torch, g)]
    for launches in drives:
        for name, n in launches.items():
            rows[name]["launches"] += n
    phase_kernel_report()
    unused = [n for n, r in rows.items() if r["launches"] == 0]
    if unused:
        raise AssertionError(f"kernels no main path launched: {unused}")
    log(f"card: {card}; main paths ms/step: "
        + ", ".join(f"{k}={v:.3f}" for k, v in step_ms.items()))
    # the order in which to redesign the kernels: first those slower than
    # one PyTorch call of the same function, by the factor; then the rest by
    # the profiled device ms per step of their kernels, summed over the
    # seven paths (every shape a path launches counts at its own time)
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
        log("redesign order, device ms per step by kernel summed over the seven "
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
