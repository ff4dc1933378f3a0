"""Metrics (``tnn_tpu.nn.metrics``): argmax and top-k accuracy, and
perplexity. Integer labels < 0
mark ignored positions and are left out of numerator and denominator, as
the loss leaves them out."""
from __future__ import annotations

import torch


def _labels_mask(labels, class_ndim):
    """Collapse one-hot labels and derive the ignore mask."""
    if labels.ndim == class_ndim + 1:
        labels = labels.argmax(dim=-1)
        mask = torch.ones(labels.shape, dtype=torch.bool,
                          device=labels.device)
    elif not labels.dtype.is_floating_point:
        mask = labels >= 0
    else:
        mask = torch.ones(labels.shape, dtype=torch.bool,
                          device=labels.device)
    return labels, mask


def class_corrects(logits, labels) -> torch.Tensor:
    """Number of argmax matches (int32)."""
    pred = logits.argmax(dim=-1)
    labels, mask = _labels_mask(labels, pred.ndim)
    return ((pred == labels) & mask).sum(dtype=torch.int32)


def accuracy(logits, labels) -> torch.Tensor:
    """Share of live positions whose argmax matches (float32)."""
    pred = logits.argmax(dim=-1)
    labels, mask = _labels_mask(labels, pred.ndim)
    hits = ((pred == labels) & mask).sum(dtype=torch.float32)
    return hits / mask.sum(dtype=torch.float32).clamp_min(1.0)


def topk_accuracy(logits, labels, k: int = 5) -> torch.Tensor:
    """Share of live positions whose label is among the k largest logits
    (float32)."""
    labels, mask = _labels_mask(labels, logits.ndim - 1)
    topk = logits.topk(k, dim=-1).indices
    hit = (topk == labels[..., None]).any(dim=-1)
    return (hit & mask).sum(dtype=torch.float32) / \
        mask.sum(dtype=torch.float32).clamp_min(1.0)


def perplexity(mean_nll) -> torch.Tensor:
    return torch.exp(torch.as_tensor(mean_nll, dtype=torch.float32))
