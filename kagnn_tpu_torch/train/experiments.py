"""The graph tasks' batch loader, the counterpart of
`kagnn_tpu/train/experiments.py::batch_loader` (the experiment scripts of
that module come with a later slice of the port)."""
from __future__ import annotations

from typing import Optional

import numpy as np

from kagnn_tpu_torch.graphs.batch import batch_graphs
from kagnn_tpu_torch.utils.device import resolve_device


def batch_loader(graphs: list[dict], spec, batch_size: int,
                 shuffle: bool = False, seed: int = 0,
                 native: Optional[bool] = None, prefetch: int = 0,
                 device=None):
    """Returns a callable yielding padded GraphBatches (static shapes) on
    `device` (CUDA unless told otherwise), one pass over `graphs` per call.

    `native`: assemble through the C++ assembler (data/native.py,
    bit-identical to `batch_graphs`): True requires it and raises when it
    does not build; None uses it when the graphs carry no edge features and
    it builds, and on the CPU falls back to `batch_graphs` when it does
    not (on the card a failed build raises); False uses `batch_graphs`.
    `prefetch`: keep that many batches in flight on a worker thread,
    host->device copies included (train/prefetch.py); 0 assembles and
    copies each batch when it is asked for. Shuffled orders come from
    `np.random.default_rng(seed)`, one permutation per pass, as in the
    JAX loader."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    assembler = None
    has_edge_feat = any(g.get("edges") is not None for g in graphs)
    if native or (native is None and not has_edge_feat):
        from kagnn_tpu_torch.data.native import NativeBatchAssembler, load

        try:
            load()
        except RuntimeError:
            if native or dev.type != "cpu":
                raise
        else:
            assembler = NativeBatchAssembler(graphs, spec)
    host = "cpu" if prefetch > 0 else dev

    def gen():
        order = rng.permutation(len(graphs)) if shuffle else np.arange(
            len(graphs))
        for i in range(0, len(order), batch_size):
            sel = order[i:i + batch_size]
            if assembler is not None:
                b = assembler.assemble(sel, device=host)
            else:
                b = batch_graphs([graphs[j] for j in sel], spec, device=host)
            yield b

    if prefetch > 0:
        from kagnn_tpu_torch.train.prefetch import prefetch_to_device

        def it():
            return prefetch_to_device(gen(), size=prefetch, device=dev)
    else:
        def it():
            return gen()

    return it
