"""Times of the fused GIN aggregate + KANLinear (`gin_fused`), of the fused
GIN aggregate + FastKANLayer (`gin_fastkan`) and of the GAT sender backward
(`gat_sender`) on the card at the main paths' shapes, one line:

    python -m kagnn_tpu_torch.utils.time_gin_gat [label] [gin|fastkan|gat]

ms per call from CUDA events (`profiling.time_ms`) on the arxiv-sized
graph, with each launched kernel's profiled ms beside it:
  * gin_fused (`gin_kan_fwd`) at (D, O) = (64, 64) and (128, 64), spline
    order 3, grid 4, over the receiver CSR whole, its longest row alone and
    its light rows alone (`time_gat.hub_row_alone`, `light_rows_alone`);
  * gin_fastkan (`gin_fastkan_fwd`) at the same (D, O), 4 centers, over the
    same three CSRs;
  * gat_sender at 4 heads of 64 columns over the sender CSR (out-degree at
    most 23: no heavy row), and over the receiver CSR walked as a sender
    CSR (idx = senders: node 0 then sends 2,748 edges, as in a graph whose
    edges run both ways), whole, its longest row alone and its light rows
    alone;
in bf16 and f32. Random inputs from a fixed seed, no checks (chip_smoke.py
and tests/test_torch_cuda.py hold the kernels to their plain versions). It
calls only the wrappers' public functions, so a checkout of another commit
is timed with this file: `PYTHONPATH=<checkout> python <this file>` from
that checkout."""
from __future__ import annotations

import sys

import torch

GIN_SHAPES = ((64, 64), (128, 64))
HEADS, C = 4, 64


def _timed(fn) -> str:
    """'<ms> [<kernel> <ms>, ...]' of fn() on the card."""
    from kagnn_tpu_torch.utils.profiling import device_profile, kernel_base_name, time_ms

    ms = time_ms(fn)
    prof = device_profile(lambda: [fn() for _ in range(3)], 3)
    split = ", ".join(f"{kernel_base_name(k)} {t:.4f}" for k, t, _ in prof.kernels)
    return f"{ms:.4f} [{split}]"


def main(label: str = "", only: str = "") -> str:
    from kagnn_tpu_torch.data import arxiv_scale_graph
    from kagnn_tpu_torch.graphs import single_graph
    from kagnn_tpu_torch.kan.bspline import make_grid
    from kagnn_tpu_torch.kernels import gat_bwd as gbw
    from kagnn_tpu_torch.kernels import gat_fused as gfu
    from kagnn_tpu_torch.kernels import gin_fastkan as gfk
    from kagnn_tpu_torch.kernels import gin_fused as gf
    from kagnn_tpu_torch.utils.time_gat import hub_row_alone, light_rows_alone

    d = arxiv_scale_graph()
    g = single_graph(d["senders"], d["receivers"], edge_pad_multiple=1024, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    n = g.n_node_pad

    def rnd(*shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(*shape, generator=gen, device="cuda") * scale).to(dtype)

    hub_idx, hub_ptr, hub_edges, hub = hub_row_alone(g)
    light_idx, light_ptr, light_edges = light_rows_alone(g)
    receiver_csrs = {"whole": (g.senders, g.recv_row_ptr, g.n_edge),
                     "hub": (hub_idx, hub_ptr, hub_edges),
                     "light": (light_idx, light_ptr, light_edges)}
    cells = []
    for dtype in (torch.bfloat16, torch.float32):
        dn = str(dtype)[6:]
        for D, O in GIN_SHAPES if only in ("", "gin") else ():
            knots = make_grid(D, 4, 3, device="cuda").t().contiguous().to(dtype)
            wb, ws = rnd(D, O, scale=0.3, dtype=dtype), rnd(7 * D, O, scale=0.3, dtype=dtype)
            x = rnd(n, D, dtype=dtype)
            for name, (idx, rp, _) in receiver_csrs.items():
                t = _timed(lambda: gf.gin_kan_fwd(x, idx, rp, knots, wb, ws, 3, 0.0))
                cells.append(f"gin_fused {dn} ({D},{O}) {name} {t}")
        for D, O in GIN_SHAPES if only in ("", "fastkan") else ():
            lw = (1.0 + rnd(D, scale=0.2, dtype=dtype), rnd(D, scale=0.1, dtype=dtype),
                  rnd(4 * D, O, scale=0.3, dtype=dtype), rnd(D, O, scale=0.3, dtype=dtype),
                  rnd(O, scale=0.1, dtype=dtype))
            x = rnd(n, D, dtype=dtype)
            for name, (idx, rp, _) in receiver_csrs.items():
                t = _timed(lambda: gfk.gin_fastkan_fwd(x, idx, rp, *lw, 0.0, -2.0, 2.0))
                cells.append(f"gin_fastkan {dn} ({D},{O}) {name} {t}")
        if only not in ("", "gat"):
            continue
        h, dout = rnd(n, HEADS * C, dtype=dtype), rnd(n, HEADS * C, scale=0.1, dtype=dtype)
        asrc, adst = rnd(n, HEADS, scale=2.0), rnd(n, HEADS, scale=2.0)
        out, alpha = gfu.gat_fwd(h, asrc, adst, g.senders, g.recv_row_ptr, g.n_edge, 0.2)
        s = (dout * out).float().reshape(n, HEADS, C).sum(2).contiguous()
        sender_csrs = {"sender CSR": (g.receivers_by_sender, g.send_row_ptr, g.n_edge)}
        sender_csrs.update({f"receiver CSR {k}": v for k, v in receiver_csrs.items()})
        for name, (idx, rp, ne) in sender_csrs.items():
            t = _timed(lambda: gbw.gat_sender(h, asrc, adst, alpha, s, dout, idx, rp, ne, 0.2))
            cells.append(f"gat_sender {dn} H{HEADS} C{C} {name} {t}")
    return (f"{label} on {torch.cuda.get_device_name(0)} (hub row {hub}, {hub_edges} "
            f"edges): " + " | ".join(cells))


if __name__ == "__main__":
    print(main(*sys.argv[1:3]), flush=True)
