#!/usr/bin/env python3
"""On-card smoke check of the PyTorch/CUDA port (`kagnn_tpu_torch`).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases (any failure raises, and the script exits non-zero):
  1. device: requires CUDA, prints the card's name and power limit, turns
     TF32 off for matmul and cuDNN;
  2. build: compiles every CUDA kernel from `kagnn_tpu_torch/csrc/` (one
     nvcc per source, all at once) and prints the build time;
  3. kernels: each of the 11 kernels against its plain PyTorch version on
     the card, at small shapes, ragged shapes (N off every tile, isolated
     nodes, a node of in-degree 301) and the main paths' shapes (the layer
     kernels also at the GAT transform's widths, 256 = 4 heads x 64), in
     f32 and bf16, with times (CUDA events) for the kernel, the plain
     version and, where one PyTorch call computes the same function, that
     call as the library yardstick (`torch.sparse.mm` on a CSR matrix; the
     port never calls it; there is none for GAT attention); then the
     forward and backward of the autograd Functions against the plain path;
  4. whole step, small graph, per node path (gin/kan, gcn/kan,
     gcn/fastkan, gin/fastkan, gat/kan, gat/fastkan): the kernel path
     (fused=True) and the plain path (fused=False) agree on logits and
     every parameter gradient;
  5. main paths: the bf16 train step of each node path at full width on
     the arxiv-sized synthetic graph (169,343 nodes, 1,166,243 edges), 2
     warm-up + 10 timed steps each, with the launch counters set to 0
     before and checked after each path, and a profiler breakdown; then
     the GIN+FastKAN fusion point, `FastKAN(x, gin_graph=(g, 0))` at the
     main shapes, forward and backward once with its counts checked the
     same way: the GIN conv sums z itself for a FastKAN net, as the JAX
     model does, so no node path launches the gin_fastkan kernel and this
     drive is the run that does;
  6. prints the kernel list as one JSON line, then the result line.

It imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12}  # dense bf16 / f32 non-tensor
NODE_KW = dict(mp_layers=3, num_features=128, hidden_channels=64,
               num_classes=40, grid_size=4, spline_order=3, skip=False,
               hidden_layers=2, heads=4, dropout=0.0)  # bench.py _NODE_KW
BF16_ULP = 2.0 ** -8  # relative spacing of bf16 values
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


def phase_build():
    from kagnn_tpu_torch.kernels import _build

    t0 = time.perf_counter()
    reports = _build.build_all()
    secs = time.perf_counter() - t0
    log(f"build: {len(_build.SOURCES)} sources in {secs:.1f} s")
    (_build.BUILD / "ptxas.txt").write_text(
        "\n".join(f"== {n}\n{r}" for n, r in reports.items()))
    for name, rep in reports.items():
        spills = [ln for ln in rep.splitlines()
                  if "spill" in ln and not ln.strip().endswith(
                      "0 bytes spill stores, 0 bytes spill loads")]
        log(f"ptxas {name}: {len(spills)} functions with spills")


def time_ms(torch, fn, iters=20, warmup=3):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes, ops, dtype):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS[dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def compare(torch, name, got, want, dtype):
    """Elementwise |got - want| <= c * max(|want|, mean |want|). f32:
    c = 1e-4, since the kernel and its plain version only sum in different
    orders; bf16: c = 4 bf16 ulps, since both round the same f32 sums to
    bf16 once and a flipped rounding costs one ulp on top of the order.
    The mean floors the scale of values near zero. Returns max |got - want|."""
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
                ms = time_ms(torch, lambda: spmm.sorted_segment_sum(*args))
                pms = time_ms(torch, lambda: spmm.sorted_segment_sum_plain(*args))
                adj = torch.sparse_csr_tensor(
                    g.send_row_ptr.long(), g.receivers_by_sender.long(),
                    torch.ones(E, dtype=dtype, device="cuda"), size=(N, N),
                    check_invariants=False)
                lib = spmm.sorted_segment_sum_plain(*args)
                torch.testing.assert_close(torch.sparse.mm(adj, dz).float(),
                                           lib.float(), rtol=0.02, atol=0.1)
                lms = time_ms(torch, lambda: torch.sparse.mm(adj, dz))
                bms, by = bound(2 * N * 64 * s + 4 * (E + N + 1), E * 64, dn)
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
                got = bf.kan_linear_bwd(*fa[:4], dout, k)
                want = bf.kan_linear_bwd_plain(*fa[:4], dout, k)
                errb = max(compare(torch, f"bspline_bwd {gname} D={D} O={O} {w}",
                                   a, b, dn)
                           for w, a, b in zip(("dx", "dwb", "dws"), got, want))
                nb1 = grid_size + k + 1
                if timed:
                    ms = time_ms(torch, lambda: bf.kan_linear_fwd(*fa))
                    pms = time_ms(torch, lambda: bf.kan_linear_fwd_plain(*fa))
                    bms, by = bound((N * D + knots.numel() + nb1 * D * O + N * O) * s,
                                    2 * N * nb1 * D * O, dn)
                    log(f"  bspline_fwd main {dn} D={D} O={O}: ms={ms:.4f} "
                        f"plain_ms={pms:.4f} bound_ms={bms:.4f} ({by})")
                    record("bspline_fwd", err, main and (D, O) == (64, 64), ms, pms, bms, by)
                    ms = time_ms(torch, lambda: bf.kan_linear_bwd(*fa[:4], dout, k))
                    pms = time_ms(torch, lambda: bf.kan_linear_bwd_plain(*fa[:4], dout, k))
                    bms, by = bound((2 * N * D + knots.numel() + 2 * nb1 * D * O
                                     + N * O) * s, 4 * N * nb1 * D * O, dn)
                    log(f"  bspline_bwd main {dn} D={D} O={O}: ms={ms:.4f} "
                        f"plain_ms={pms:.4f} bound_ms={bms:.4f} ({by})")
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
                    ms = time_ms(torch, lambda: gf.gin_kan_fwd(*ga))
                    pms = time_ms(torch, lambda: gf.gin_kan_fwd_plain(*ga))
                    nb1 = grid_size + k + 1
                    bms, by = bound((2 * N * D + knots.numel() + nb1 * D * O + N * O) * s
                                    + 4 * (E + N + 1),
                                    E * D + 2 * N * nb1 * D * O, dn)
                    log(f"  gin_fused main {dn} D={D} O={O}: ms={ms:.4f} "
                        f"plain_ms={pms:.4f} bound_ms={bms:.4f} ({by})")
                    record("gin_fused", err, main and D == 64, ms, pms, bms, by)
                else:
                    record("gin_fused", err, False)
    phase_new_kernels(torch, big, rows)
    return rows


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
            err = compare(torch, f"gcn_agg {gname} ({N},64)", ga.gcn_agg_fwd(*args),
                          ga.gcn_agg_plain(*args), dn)
            times = {}
            if timed:
                ms = time_ms(torch, lambda: ga.gcn_agg_fwd(*args))
                pms = time_ms(torch, lambda: ga.gcn_agg_plain(*args))
                mat = csr_gcn_matrix(torch, g, dinv, dtype)
                torch.testing.assert_close(torch.sparse.mm(mat, hs).float(),
                                           ga.gcn_agg_plain(*args).float(),
                                           rtol=0.02, atol=0.1)
                lms = time_ms(torch, lambda: torch.sparse.mm(mat, hs))
                bms, by = bound(2 * N * 64 * s + 4 * (N + E + N + 1),
                                E * 64 + 2 * N * 64, dn)
                log(f"  gcn_agg main {dn}: ms={ms:.4f} plain_ms={pms:.4f} "
                    f"library_ms={lms:.4f} bound_ms={bms:.4f} ({by})")
                times = dict(ms=ms, plain_ms=pms, bound_ms=bms, bound_by=by,
                             library_ms=lms)
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
                errb = max(compare(torch, f"fastkan_bwd {gname} D={D} O={O} {w}",
                                   a, b, dn)
                           for w, a, b in zip(
                               ("dx", "dlng", "dlnb", "dw", "dwb", "dbb"),
                               fk.fastkan_layer_bwd(*ba),
                               fk.fastkan_layer_bwd_plain(*ba)))
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
                    ms = time_ms(torch, fn)
                    pms = time_ms(torch, plain, iters=5)
                    bms, by = bound(nbytes, ops, dn)
                    log(f"  {name} main {dn} D={D} O={O}: ms={ms:.4f} "
                        f"plain_ms={pms:.4f} bound_ms={bms:.4f} ({by})")
                    record_row(rows[name], e, rep, ms=ms, plain_ms=pms,
                               bound_ms=bms, bound_by=by)
    phase_gat_kernels(torch, big, rows)
    phase_autograd_functions(torch)


def phase_gat_kernels(torch, big, rows):
    """The three GAT kernels against their plain versions at the main
    paths' heads and width (H 4, C 64), f32 and bf16, on a small graph, the
    ragged one and the main paths' graph (`big`), timed on the latter.
    Bytes of the bound: h and dout read once, out or dh written once, the
    (N, H) f32 arrays, and the indices of the valid edges; operations: the
    products of the valid edges. No PyTorch call computes GAT attention, so
    there is no library time."""
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
                ms = time_ms(torch, fn)
                pms = time_ms(torch, plain, iters=5)
                bms, by = bound(nbytes, n_ops, dn)
                log(f"  {name} main {dn} H={H} C={C}: ms={ms:.4f} "
                    f"plain_ms={pms:.4f} bound_ms={bms:.4f} ({by}) library_ms=none")
                record_row(rows[name], e, main, ms=ms, plain_ms=pms,
                           bound_ms=bms, bound_by=by, library_ms=None)
            # the longest receiver row alone (every other row empty): the
            # time its one warp needs, a floor under the launches above
            deg = g.recv_row_ptr[1:] - g.recv_row_ptr[:-1]
            hub = int(deg[:g.n_node].argmax())
            d_hub = int(deg[hub])
            e0 = int(g.recv_row_ptr[hub])
            snd = g.senders[e0:e0 + d_hub].contiguous()
            rp = torch.zeros_like(g.recv_row_ptr)
            rp[hub + 1:] = d_hub
            hub_fwd = time_ms(torch, lambda: gfu.gat_fwd(h, asrc, adst, snd, rp,
                                                         d_hub, slope))
            hub_dadst = time_ms(torch, lambda: gbw.gat_dadst(
                h, asrc, adst, alpha, S, dout, snd, rp, d_hub, slope))
            log(f"  GAT hub row alone {dn} (node {hub}, in-degree {d_hub}): "
                f"gat_fwd {hub_fwd:.4f} ms, gat_dadst {hub_dadst:.4f} ms")


def phase_autograd_functions(torch):
    """FastKANLayerFn -> GcnAggregate -> GinFastKan chained on a small
    graph, then GatAttention twice in a row (kernels/selfcheck.py, shared
    with tests/test_torch_cuda.py)."""
    from kagnn_tpu_torch.graphs import single_graph
    from kagnn_tpu_torch.kernels.selfcheck import (fastkan_gcn_chain,
                                                   gat_attention_chain)

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


def phase_small_step(torch, conv, arch):
    """Kernel path against the plain path on the card, f32 and bf16."""
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

    def run(fused, cd):
        m = NodeClassifier(fused=fused, compute_dtype=cd, device="cuda", **kw)
        m.train()
        logits = m(g)
        loss = masked_softmax_cross_entropy(logits, g.y, g.node_mask)
        loss.backward()
        return logits.detach(), {n: p.grad for n, p in m.named_parameters()}

    nm = g.node_mask
    lk, gk = run(True, None)
    lp, gp = run(False, None)
    # f32: same tolerances as the CPU parity tests (values rtol 1e-4 /
    # atol 1e-5, grads rtol 1e-3 / atol 1e-5): only summation order differs
    torch.testing.assert_close(lk[nm], lp[nm], rtol=1e-4, atol=1e-5)
    worst = 0.0
    for n in gp:
        torch.testing.assert_close(gk[n], gp[n], rtol=1e-3, atol=1e-5, msg=n)
        worst = max(worst, (gk[n] - gp[n]).abs().max().item())
    log(f"small step {conv}/{arch} f32: logits max_abs_err="
        f"{(lk[nm] - lp[nm]).abs().max().item():.3e}, "
        f"{len(gp)} grads agree (worst {worst:.3e})")
    # bf16 kernel path against the f32 plain path: the test_bf16.py bar
    lb, _ = run(True, torch.bfloat16)
    rel = ((lb[nm] - lp[nm]).abs().mean() / (lp[nm].abs().mean() + 1e-6)).item()
    log(f"small step {conv}/{arch} bf16 vs f32: mean relative error "
        f"{rel:.4f} (bar 0.1)")
    if not rel < 0.1:
        raise AssertionError(f"bf16 kernel path too far from f32: {rel}")


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


def counters():
    """Every kernel wrapper with its launch counter, by kernel name."""
    from kagnn_tpu_torch.kernels import bspline_fused as bf
    from kagnn_tpu_torch.kernels import fastkan_layer as fk
    from kagnn_tpu_torch.kernels import gat_bwd as gbw
    from kagnn_tpu_torch.kernels import gat_fused as gfu
    from kagnn_tpu_torch.kernels import gcn_agg as ga
    from kagnn_tpu_torch.kernels import gin_fastkan as gfk
    from kagnn_tpu_torch.kernels import gin_fused as gf
    from kagnn_tpu_torch.kernels import spmm

    return {"spmm": spmm.sorted_segment_sum, "bspline_fwd": bf.kan_linear_fwd,
            "bspline_bwd": bf.kan_linear_bwd, "gin_fused": gf.gin_kan_fwd,
            "gcn_agg": ga.gcn_agg_fwd, "fastkan_fwd": fk.fastkan_layer_fwd,
            "fastkan_bwd": fk.fastkan_layer_bwd,
            "gin_fastkan": gfk.gin_fastkan_fwd, "gat_fwd": gfu.gat_fwd,
            "gat_dadst": gbw.gat_dadst, "gat_sender": gbw.gat_sender}


def check_launches(name, launches, per_run, runs=1):
    """Every kernel launched exactly per_run[k] * runs times (0 if absent)."""
    for k, n in launches.items():
        if n != per_run.get(k, 0) * runs:
            raise AssertionError(f"{name}: {k} launched {n} times in {runs} "
                                 f"runs, expected {per_run.get(k, 0)} per run")


def phase_main_path(torch, g, conv, arch):
    from kagnn_tpu_torch.models import NodeClassifier
    from kagnn_tpu_torch.train import make_node_steps

    model = NodeClassifier(conv_type=conv, architecture=arch, fused=True,
                           compute_dtype=torch.bfloat16, seed=0,
                           device="cuda", **NODE_KW)
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    train_step, evaluate = make_node_steps(model, opt)
    mask = g.node_mask
    fns = counters()
    per_step = MAIN_PATHS[(conv, arch)]
    warmup, timed = 2, 10

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for f in fns.values():
        f.launches = 0
    losses = [train_step(g, mask) for _ in range(warmup)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses += [train_step(g, mask) for _ in range(timed)]
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / timed
    launches = {k: f.launches for k, f in fns.items()}
    peak = torch.cuda.max_memory_allocated() / 2**30

    vals = [float(v) for v in losses]
    name = f"{conv}/{arch}"
    log(f"main path {name}: {warmup}+{timed} steps, ms/step={ms:.3f}, "
        f"peak_mem={peak:.3f} GiB, losses {vals[0]:.5f} -> {vals[-1]:.5f}")
    log(f"main path {name} launches: {launches}")
    if not all(math.isfinite(v) for v in vals):
        raise AssertionError(f"non-finite loss on {name}: {vals}")
    check_launches(name, launches, per_step, warmup + timed)
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
    profile_steps(torch, lambda: train_step(g, mask), ms)
    return launches, ms


def profile_steps(torch, step, step_ms, steps=3):
    """Device time per step by kernel, from torch.profiler over a few main
    path steps (after the counted run, so its launches are not counted).
    The busy share compares the summed kernel time with the timed run's
    ms/step; the profiler's own overhead is outside both."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    total = sum(e.self_device_time_total for e in kernels) / 1e3 / steps
    if total == 0.0:
        log("profile: the profiler saw no device time (not measured)")
        return
    log(f"profile: {total:.3f} ms of kernels per step, busy share "
        f"{total / step_ms:.3f} of the timed {step_ms:.3f} ms/step")
    kernels.sort(key=lambda e: -e.self_device_time_total)
    for e in kernels[:15]:
        t = e.self_device_time_total / 1e3 / steps
        log(f"  {t:8.4f} ms/step {e.count // steps:4d} calls/step "
            f"{t / total:6.3f}  {e.key[:90]}")
    # the host side: self CPU time by operator (inflated by the profiler's
    # own cost, so only the order is read)
    host = [e for e in prof.key_averages() if e.device_type == DeviceType.CPU]
    host.sort(key=lambda e: -e.self_cpu_time_total)
    log(f"  host: {sum(e.self_cpu_time_total for e in host) / 1e3 / steps:.3f} "
        f"ms of self CPU time per step under the profiler; the largest:")
    for e in host[:8]:
        log(f"  {e.self_cpu_time_total / 1e3 / steps:8.4f} ms/step "
            f"{e.count // steps:4d} calls/step  {e.key[:70]}")


def phase_fusion_point(torch, g):
    """FastKAN([128, 64, 64], fused, bf16)(x, gin_graph=(g, 0.0)) on the
    main graph, forward and backward once, with the counters set to 0
    before and read after (FUSION_POINT). Returns the launches."""
    from kagnn_tpu_torch.kan import FastKAN

    net = FastKAN([NODE_KW["num_features"], NODE_KW["hidden_channels"],
                   NODE_KW["hidden_channels"]], num_grids=NODE_KW["grid_size"],
                  fused=True, compute_dtype=torch.bfloat16, device="cuda")
    x = g.nodes.detach().clone().requires_grad_(True)
    fns = counters()
    torch.cuda.synchronize()
    for f in fns.values():
        f.launches = 0
    out = net(x, gin_graph=(g, 0.0))
    out[g.node_mask].float().sum().backward()
    torch.cuda.synchronize()
    launches = {k: f.launches for k, f in fns.items()}
    log(f"fusion point FastKAN(x, gin_graph=(g, 0)) launches: {launches}")
    check_launches("fusion point", launches, FUSION_POINT)
    if not (torch.isfinite(out[g.node_mask]).all()
            and torch.isfinite(x.grad).all()):
        raise AssertionError("fusion point: non-finite output or gradient")
    return launches


def main() -> int:
    import torch

    card = phase_device(torch)
    phase_build()
    g = main_graph(torch)
    log("kernels against their plain versions:")
    rows = phase_kernels(torch, g)
    for conv, arch in MAIN_PATHS:
        phase_small_step(torch, conv, arch)
    step_ms = {}
    for conv, arch in MAIN_PATHS:
        launches, step_ms[f"{conv}/{arch}"] = phase_main_path(torch, g, conv, arch)
        for name, n in launches.items():
            rows[name]["launches"] += n
    for name, n in phase_fusion_point(torch, g).items():
        rows[name]["launches"] += n
    unused = [n for n, r in rows.items() if r["launches"] == 0]
    if unused:
        raise AssertionError(f"kernels no main path launched: {unused}")
    log(f"card: {card}; main paths ms/step: "
        + ", ".join(f"{k}={v:.3f}" for k, v in step_ms.items()))
    print(json.dumps({"kernels": list(rows.values())}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
