"""Checkpointing, the counterpart of `kagnn_tpu/train/checkpoint.py`: a full
resume (model, optimizer state and step), where the JAX module saves its
TrainState with Orbax.

`save` and `restore` are `torch.save` and `torch.load` of one dict: the
model's `state_dict` (parameters, BatchNorm statistics, the KAN knot
buffers), the optimizer's `state_dict` (Adam's moments and step counts; a
capturable Adam's step tensors stay on the card) and the step. Restored into
a fresh model and a fresh optimizer, training continues exactly as it would
have without the interruption.
"""
from __future__ import annotations

import os
from typing import Optional

import torch


def save(path: str, model, optimizer=None, step: int = 0) -> None:
    """Write the model's and the optimizer's state and `step` to `path`
    (directories made as needed; the file replaced atomically)."""
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    state = {"model": model.state_dict(), "step": int(step),
             "optimizer": None if optimizer is None else optimizer.state_dict()}
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(state, tmp)
    os.replace(tmp, path)


def restore(path: str, model, optimizer=None) -> int:
    """Load a `save`d state into `model` (and `optimizer`), in place, onto
    the devices they hold their tensors on. Returns the step."""
    dev = next(model.parameters()).device
    state = torch.load(os.path.abspath(path), map_location=dev,
                       weights_only=True)
    model.load_state_dict(state["model"])
    if optimizer is not None:
        if state["optimizer"] is None:
            raise ValueError(f"{path} holds no optimizer state")
        optimizer.load_state_dict(state["optimizer"])
    return state["step"]


class BestValKeeper:
    """The best-validation state, kept as a cloned copy of the model's
    state_dict on its device (never a reference to the live parameters),
    with an optional spill to disk (the reference keeps the best state on
    disk every epoch, utils.py:181-183)."""

    def __init__(self, save_dir: Optional[str] = None, name: str = "best"):
        self.best_loss = float("inf")
        self.best_state: Optional[dict] = None
        self.save_dir = save_dir
        self.name = name

    def update(self, val_loss: float, model) -> bool:
        if val_loss < self.best_loss:
            self.best_loss = val_loss
            self.best_state = {k: v.detach().clone()
                               for k, v in model.state_dict().items()}
            if self.save_dir:
                save(os.path.join(self.save_dir, self.name), model)
            return True
        return False
