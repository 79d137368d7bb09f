"""Masked losses and metrics over padded batches, the counterparts of
`kagnn_tpu/train/losses.py::masked_softmax_cross_entropy`, `masked_nll`,
`masked_l1` and `masked_accuracy`."""
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


def _pick_label_column(values: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """values[i, labels[i]] as the JAX select-reduce computes it: the sum
    over classes of where(class == label, value, 0)."""
    cls = torch.arange(values.shape[-1], device=values.device)
    zero = torch.zeros((), dtype=values.dtype, device=values.device)
    return torch.where(cls == labels[:, None], values, zero).sum(-1)


def masked_nll(log_probs: torch.Tensor, labels: torch.Tensor,
               mask: torch.Tensor) -> torch.Tensor:
    """Mean negative log-likelihood of integer labels over the masked rows
    (inputs already log-softmaxed, the reference's F.nll_loss)."""
    picked = _pick_label_column(log_probs, labels.long())
    m = mask.to(log_probs.dtype)
    return -(picked * m).sum() / m.sum().clamp_min(1.0)


def masked_l1(pred: torch.Tensor, target: torch.Tensor,
              mask: torch.Tensor) -> torch.Tensor:
    """Mean absolute error over the masked rows; pred (N, 1) or (N,),
    target broadcastable."""
    pred = pred.reshape(pred.shape[0], -1)
    target = target.reshape(target.shape[0], -1).to(pred.dtype)
    err = (pred - target).abs().mean(-1)
    m = mask.to(pred.dtype)
    return (err * m).sum() / m.sum().clamp_min(1.0)
