"""Masked losses and metrics over padded batches, the counterparts of
`kagnn_tpu/train/losses.py::masked_softmax_cross_entropy` and
`masked_accuracy`."""
from __future__ import annotations

import torch


def masked_softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                                 mask: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy over the rows where mask is True."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    picked = logits.gather(1, labels.long()[:, None])[:, 0]
    m = mask.float()
    return ((lse - picked) * m).sum() / m.sum().clamp_min(1.0)


def masked_accuracy(logits: torch.Tensor, labels: torch.Tensor,
                    mask: torch.Tensor) -> torch.Tensor:
    correct = (logits.argmax(-1) == labels).float() * mask.float()
    return correct.sum() / mask.float().sum().clamp_min(1.0)
