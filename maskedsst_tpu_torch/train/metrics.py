"""Classification metrics, as the JAX package's:

* micro accuracy with ignored-label masking;
* macro accuracy as ``torchmetrics.Accuracy('multiclass', average='macro')``:
  per-class recall averaged over the classes present in the target;
* the confusion matrix, rows = true class, columns = predicted; ids out of
  range (negative or >= num_classes) give all-zero one-hot rows and count
  nowhere.
"""

from __future__ import annotations

import torch


def micro_accuracy(pred: torch.Tensor, label: torch.Tensor, ignored_label: int = -1) -> torch.Tensor:
    """Share of correctly predicted non-ignored pixels; 0 when none is valid."""
    valid = label != ignored_label
    total = valid.sum()
    correct = ((pred == label) & valid).sum()
    return torch.where(total > 0, correct / total.clamp_min(1), torch.zeros((), device=pred.device))


def _one_hot(x: torch.Tensor, num_classes: int) -> torch.Tensor:
    return (x[..., None] == torch.arange(num_classes, device=x.device)).float()


def confusion_matrix(pred: torch.Tensor, label: torch.Tensor, num_classes: int,
                     ignored_label: int = -1) -> torch.Tensor:
    """[num_classes, num_classes] counts (fp32); ignored pixels count nowhere."""
    pred, label = pred.reshape(-1), label.reshape(-1)
    valid = (label != ignored_label).float()
    return (_one_hot(label, num_classes) * valid[:, None]).t() @ _one_hot(pred, num_classes)


def macro_accuracy(pred: torch.Tensor, label: torch.Tensor, num_classes: int,
                   ignored_label: int = -1) -> torch.Tensor:
    """Mean per-class recall over the classes with support."""
    cm = confusion_matrix(pred, label, num_classes, ignored_label)
    support = cm.sum(dim=1)
    recall = torch.where(support > 0, cm.diagonal() / support.clamp_min(1), torch.zeros_like(support))
    present = (support > 0).float()
    return (recall * present).sum() / present.sum().clamp_min(1.0)
