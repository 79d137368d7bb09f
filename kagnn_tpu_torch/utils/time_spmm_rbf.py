"""Times of the segment sum (`spmm`) and the RBF backward (`rbf_bwd`) on the
card at the main paths' shapes, one line each:

    python -m kagnn_tpu_torch.utils.time_spmm_rbf [label] [spmm|rbf]

ms per call from CUDA events (`profiling.time_ms`) on the arxiv-sized
graph: spmm over the receiver CSR with idx = senders (the gin/fastkan step's
sum of z) at D 128 and 64, over that CSR's longest row alone and its light
rows alone (`spmm_cases`, which chip_smoke.py times too), and over the
sender CSR with idx = receivers_by_sender (A^T dz) at D 64, in bf16 and f32,
beside `torch.sparse.mm` of a CSR of the same matrix (a yardstick the port
never calls); rbf_bwd at the base-free FastKAN's widths (128, 64), (64, 64)
and (64, 40) at 8 centers for x / w in f32 / bf16, bf16 / bf16 and f32 /
f32, with each launched kernel's profiled ms and, where w is bf16, the
reading of its walked dW against the plain walk
(`selfcheck.dw_walk_check`, reported, not raised: a variant of the kernel
that fails the bar is timed too). Random inputs from a fixed seed
(chip_smoke.py and tests/test_torch_cuda.py hold the kernels to their
plain versions). It calls only the wrappers' public functions, so a
checkout of another commit can be timed with this file:
`PYTHONPATH=<checkout> python <this file>` from that checkout."""
from __future__ import annotations

import sys

import torch

from kagnn_tpu_torch.utils.time_gat import hub_row_alone, light_rows_alone

RBF_SHAPES = ((128, 64), (64, 64), (64, 40))
RBF_DTYPES = (("float32", "bfloat16"), ("bfloat16", "bfloat16"), ("float32", "float32"))
RBF_G = 8


def spmm_cases(g) -> dict:
    """name -> (row_ptr, idx) of the CSRs spmm is timed over: the receiver
    CSR with idx = senders, its longest row alone, its light rows alone
    (more than 64 valid edges is heavy; the padded edges dropped), and the
    sender CSR with idx = receivers_by_sender."""
    hub_idx, hub_ptr, _, _ = hub_row_alone(g)
    light_idx, light_ptr, _ = light_rows_alone(g)
    return {"receiver": (g.recv_row_ptr, g.senders), "hub": (hub_ptr, hub_idx),
            "light": (light_ptr, light_idx),
            "sender": (g.send_row_ptr, g.receivers_by_sender)}


def csr_matrix(row_ptr, idx, n: int, dtype):
    """The (n, n) CSR matrix of ones that spmm multiplies by over row_ptr and
    idx: the library yardstick `torch.sparse.mm(a, msgs)`."""
    return torch.sparse_csr_tensor(row_ptr.long(), idx.long(),
                                   torch.ones(idx.numel(), dtype=dtype, device=idx.device),
                                   size=(n, n), check_invariants=False)


def main(label: str = "", only: str = "") -> str:
    from kagnn_tpu_torch.data import arxiv_scale_graph
    from kagnn_tpu_torch.graphs import single_graph
    from kagnn_tpu_torch.kernels import rbf_fused as rf
    from kagnn_tpu_torch.kernels import spmm
    from kagnn_tpu_torch.kernels._common import dw_tile
    from kagnn_tpu_torch.kernels.selfcheck import dw_walk_check
    from kagnn_tpu_torch.utils.profiling import device_profile, kernel_base_name, time_ms

    d = arxiv_scale_graph()
    g = single_graph(d["senders"], d["receivers"], edge_pad_multiple=1024, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    n = g.n_node_pad
    cells = []
    for dtype in (torch.bfloat16, torch.float32) if only != "rbf" else ():
        for name, (rp, idx) in spmm_cases(g).items():
            for D in ((128, 64) if name != "sender" else (64,)):
                msgs = torch.randn(n, D, generator=gen, device="cuda").to(dtype)
                ms = time_ms(lambda: spmm.sorted_segment_sum(msgs, rp, idx))
                lib = ""
                if name in ("receiver", "sender"):
                    a = csr_matrix(rp, idx, n, dtype)
                    lib = f" (sparse.mm {time_ms(lambda: torch.sparse.mm(a, msgs)):.4f})"
                cells.append(f"spmm {str(dtype)[6:]} {name} D{D} {ms:.4f}{lib}")
    for xn, wn in RBF_DTYPES if only != "spmm" else ():
        for D, O in RBF_SHAPES:
            x = (torch.randn(n, D, generator=gen, device="cuda") * 1.5).to(getattr(torch, xn))
            w = (torch.randn(RBF_G * D, O, generator=gen, device="cuda") * 0.3).to(
                getattr(torch, wn))
            dout = torch.randn(n, O, generator=gen, device="cuda").to(x.dtype)
            fn = lambda: rf.rbf_spline_bwd(x, w, dout, -2.0, 2.0)  # noqa: E731
            ms = time_ms(fn)
            prof = device_profile(lambda: [fn() for _ in range(3)], 3)
            split = ", ".join(f"{kernel_base_name(k)} {t:.4f}" for k, t, _ in prof.kernels)
            walk = ""
            if wn == "bfloat16":
                c, ih = rf.constants(-2.0, 2.0, RBF_G, x.dtype)
                basis, _ = rf.basis_plain(x, c, ih, round_exp=False)
                lines = []
                try:
                    dw_walk_check("dW", basis, dout.float(), dw_tile(n), fn()[1],
                                  rf.rbf_spline_bwd_plain(x, w, dout, -2.0, 2.0, False)[1],
                                  log=lines.append)
                except AssertionError:
                    pass  # the logged line says FAIL
                walk = " " + lines[0].strip()
                del basis
            cells.append(f"rbf_bwd {xn[:4]}/{wn[:4]} ({D},{O}) {ms:.4f} [{split}]{walk}")
    return f"{label}: " + " | ".join(cells)


if __name__ == "__main__":
    print(main(*sys.argv[1:3]), flush=True)
