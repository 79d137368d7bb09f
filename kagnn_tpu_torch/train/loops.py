"""Training steps, the counterparts of `kagnn_tpu/train/loops.py`
`make_node_steps` and `EarlyStopper`.

The JAX steps thread a TrainState through a jitted function; here the
model and the optimizer hold the state and are updated in place. With
`torch.optim.Adam(params, lr=1e-3)` (betas 0.9/0.999, eps 1e-8) the update
is that of `optax.adam(1e-3)`.
"""
from __future__ import annotations

import torch

from kagnn_tpu_torch.train import losses


class EarlyStopper:
    """Reference node_classification_clean/utils.py:68-86: returns
    (should_save, should_stop)."""

    def __init__(self, patience: int = 1, min_delta: float = 0.0):
        self.patience = patience
        self.min_delta = min_delta
        self.counter = 0
        self.min_validation_loss = float("inf")

    def early_stop(self, validation_loss: float) -> tuple[bool, bool]:
        should_save = False
        if validation_loss < self.min_validation_loss:
            self.min_validation_loss = validation_loss
            self.counter = 0
            should_save = True
        elif validation_loss >= self.min_validation_loss + self.min_delta:
            self.counter += 1
            if self.counter >= self.patience:
                return False, True
        return should_save, False


def make_node_steps(model, optimizer):
    """Full-batch node classification: masked CE on a per-call mask.
    Returns (train_step(batch, mask) -> loss, evaluate(batch) -> logits)."""

    def train_step(batch, mask):
        model.train()
        optimizer.zero_grad(set_to_none=True)
        loss = losses.masked_softmax_cross_entropy(model(batch), batch.y, mask)
        loss.backward()
        optimizer.step()
        return loss.detach()

    def evaluate(batch):
        """Logits of one forward in eval mode (running BN statistics)."""
        model.eval()
        with torch.no_grad():
            return model(batch)

    return train_step, evaluate
