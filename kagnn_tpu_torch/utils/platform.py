"""Platform selection for the port's drivers, the counterpart of
`kagnn_tpu/utils/platform.py`: the same `KAGNN_PLATFORM` variable that the
JAX drivers honour. `cpu` selects the CPU (the plain PyTorch versions of
the kernels); unset, `cuda` or `gpu` select the card, and without a card
`resolve_device` raises rather than carry on on the CPU."""
from __future__ import annotations

import os

import torch

from kagnn_tpu_torch.utils.device import resolve_device

_DEVICES = {"cpu": "cpu", "cuda": "cuda", "gpu": "cuda"}


def platform_device() -> torch.device:
    """The device `KAGNN_PLATFORM` names (the card when it is unset)."""
    want = os.environ.get("KAGNN_PLATFORM") or "cuda"
    if want.lower() not in _DEVICES:
        raise ValueError(f"KAGNN_PLATFORM={want!r}: the port runs on "
                         f"{sorted(_DEVICES)}")
    return resolve_device(_DEVICES[want.lower()])
