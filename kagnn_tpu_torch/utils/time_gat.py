"""Times of the GAT attention kernels that split heavy receiver rows
(`gat_fwd`, `gat_dadst`) on the card at the main paths' shape, as one line:

    python -m kagnn_tpu_torch.utils.time_gat [label]

ms per call from CUDA events (`profiling.time_ms`) at 4 heads of 64 columns
in f32 and bf16, on the arxiv-sized graph whole, on its longest receiver
row alone and on its light rows alone (`hub_row_alone`, `light_rows_alone`,
which chip_smoke.py times too); random inputs from a fixed seed, no checks
(chip_smoke.py and tests/test_torch_cuda.py hold the kernels to their plain
versions). For timing a variant of a kernel (the piece size, say): edit its
source, and `GAT_PIECE` with it, between two runs in a throwaway copy of the
repository; the changed source is rebuilt at first use."""
from __future__ import annotations

import sys

import torch

from kagnn_tpu_torch.kernels._common import GAT_PIECE


def hub_row_alone(g):
    """(senders, row_ptr, n_edge, row) of a CSR that keeps only g's
    longest receiver row (every other row empty); n_edge is its in-degree."""
    deg = g.recv_row_ptr[1:] - g.recv_row_ptr[:-1]
    hub = int(deg[:g.n_node].argmax())
    d_hub = int(deg[hub])
    e0 = int(g.recv_row_ptr[hub])
    row_ptr = torch.zeros_like(g.recv_row_ptr)
    row_ptr[hub + 1:] = d_hub
    return g.senders[e0:e0 + d_hub].contiguous(), row_ptr, d_hub, hub


def light_rows_alone(g):
    """(senders, row_ptr, n_edge) of g's receiver CSR without its heavy
    rows (more than GAT_PIECE valid edges)."""
    rp = g.recv_row_ptr.long().clamp(max=g.n_edge)
    deg = rp[1:] - rp[:-1]
    keep = deg <= GAT_PIECE
    rows = torch.repeat_interleave(torch.arange(deg.numel(), device=deg.device), deg)
    senders = g.senders[:g.n_edge][keep[rows]].contiguous()
    kept = torch.cumsum(torch.where(keep, deg, 0), 0)
    return senders, torch.cat([kept.new_zeros(1), kept]).int(), senders.numel()


def main(label: str = "") -> str:
    from kagnn_tpu_torch.data import arxiv_scale_graph
    from kagnn_tpu_torch.graphs import single_graph
    from kagnn_tpu_torch.kernels import gat_bwd as gbw
    from kagnn_tpu_torch.kernels import gat_fused as gfu
    from kagnn_tpu_torch.utils.profiling import time_ms

    d = arxiv_scale_graph()
    g = single_graph(d["senders"], d["receivers"], edge_pad_multiple=1024,
                     device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    n, heads, c = g.n_node_pad, 4, 64

    def rnd(*shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(*shape, generator=gen, device="cuda") * scale).to(dtype)

    hub = hub_row_alone(g)
    csrs = (("whole", (g.senders, g.recv_row_ptr, g.n_edge)),
            ("hub", hub[:3]), ("light", light_rows_alone(g)))
    cells = []
    for dtype in (torch.bfloat16, torch.float32):
        h, dout = rnd(n, heads * c, dtype=dtype), rnd(n, heads * c, scale=0.1, dtype=dtype)
        asrc, adst = rnd(n, heads, scale=2.0), rnd(n, heads, scale=2.0)
        out, alpha = gfu.gat_fwd(h, asrc, adst, g.senders, g.recv_row_ptr, g.n_edge, 0.2)
        s = (dout * out).float().reshape(n, heads, c).sum(2).contiguous()
        for name, (snd, rp, ne) in csrs:
            fwd = time_ms(lambda: gfu.gat_fwd(h, asrc, adst, snd, rp, ne, 0.2))
            dadst = time_ms(lambda: gbw.gat_dadst(h, asrc, adst, alpha, s, dout, snd, rp,
                                                  ne, 0.2))
            cells.append(f"{str(dtype)[6:]} {name} fwd {fwd:.4f} dadst {dadst:.4f}")
    return f"{label} piece {GAT_PIECE} (hub row {hub[3]}, in-degree {hub[2]}): " + \
        " | ".join(cells)


if __name__ == "__main__":
    print(main(sys.argv[1] if len(sys.argv) > 1 else ""), flush=True)
