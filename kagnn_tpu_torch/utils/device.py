"""Device selection for the port's entry points."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another. Raises when CUDA is asked for (or implied) and there is none,
    so that a run never carries on quietly on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "kagnn_tpu_torch runs on a CUDA device unless told otherwise, "
            "and no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    return dev
