"""Times of the bf16 layer forwards (`kan_linear_fwd`, `fastkan_layer_fwd`)
at the main paths' shapes on the card, as one line:

    python -m kagnn_tpu_torch.utils.time_forwards [label]

ms per call from CUDA events (`profiling.time_ms`) at 169,344 rows (the
arxiv-sized graph's), random inputs from a fixed seed, no checks (chip_smoke.py
and tests/test_torch_cuda.py hold the kernels to their plain versions). For
timing a variant of a kernel: edit its source between two runs in a
throwaway copy of the repository; the changed source is rebuilt at first
use."""
from __future__ import annotations

import sys

import torch

from kagnn_tpu_torch.kan.bspline import make_grid
from kagnn_tpu_torch.kernels import bspline_fused as bf
from kagnn_tpu_torch.kernels import fastkan_layer as fk
from kagnn_tpu_torch.utils.profiling import time_ms

ROWS = 169_344
SHAPES = ((64, 64), (64, 40), (128, 64), (128, 256), (256, 256), (256, 40))


def main(label: str = "") -> str:
    gen = torch.Generator(device="cuda").manual_seed(0)

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device="cuda") * scale).to(torch.bfloat16)

    cells = []
    for D, O in SHAPES:
        x = rnd(ROWS, D)
        knots = make_grid(D, 4, 3, device="cuda").t().contiguous().to(torch.bfloat16)
        kan = (x, knots, rnd(D, O, scale=0.3), rnd(7 * D, O, scale=0.3), 3)
        fast = (x, 1.0 + rnd(D, scale=0.2), rnd(D, scale=0.1), rnd(4 * D, O, scale=0.3),
                rnd(D, O, scale=0.3), rnd(O, scale=0.1), -2.0, 2.0)
        cells.append(f"({D},{O}) bspline {time_ms(lambda: bf.kan_linear_fwd(*kan)):.4f} "
                     f"fastkan {time_ms(lambda: fk.fastkan_layer_fwd(*fast)):.4f}")
    return f"{label} " + " | ".join(cells)


if __name__ == "__main__":
    print(main(sys.argv[1] if len(sys.argv) > 1 else ""), flush=True)
