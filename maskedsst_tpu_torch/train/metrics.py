"""Classification metrics, as the JAX package's:

* micro accuracy with ignored-label masking;
* macro accuracy as ``torchmetrics.Accuracy('multiclass', average='macro')``:
  per-class recall averaged over the classes present in the target;
* the confusion matrix, rows = true class, columns = predicted; ids out of
  range (negative or >= num_classes) give all-zero one-hot rows and count
  nowhere;
* the DeepHyperX report of a confusion matrix: overall accuracy in
  percent, per-class F1, Cohen's kappa.
"""

from __future__ import annotations

import torch


def micro_accuracy(pred: torch.Tensor, label: torch.Tensor, ignored_label: int = -1) -> torch.Tensor:
    """Share of correctly predicted non-ignored pixels; 0 when none is valid."""
    valid = label != ignored_label
    return micro_from_counts(((pred == label) & valid).sum(), valid.sum())


def micro_from_counts(correct: torch.Tensor, total: torch.Tensor) -> torch.Tensor:
    """``correct / total`` (int64 counts), 0 when ``total`` is 0."""
    return torch.where(total > 0, correct / total.clamp_min(1),
                       torch.zeros((), device=correct.device))


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
    return macro_from_cm(confusion_matrix(pred, label, num_classes, ignored_label))


def macro_from_cm(cm: torch.Tensor) -> torch.Tensor:
    """Mean per-class recall of a confusion matrix over the classes with
    support."""
    support = cm.sum(dim=1)
    recall = torch.where(support > 0, cm.diagonal() / support.clamp_min(1), torch.zeros_like(support))
    present = (support > 0).float()
    return (recall * present).sum() / present.sum().clamp_min(1.0)


def classification_report(cm: torch.Tensor) -> dict:
    """DeepHyperX ``metrics`` of a confusion matrix (DeepHyperX/utils.py:331-385),
    as the JAX ``classification_report``: accuracy in percent, per-class F1
    (0 where a class is neither true nor predicted), kappa; zero
    denominators clamped (a total of 1 at least, 1 - pe at least 1e-12)."""
    cm = cm.float()
    total = cm.sum().clamp_min(1.0)
    diag = cm.diagonal()
    denom = cm.sum(dim=1) + cm.sum(dim=0)
    f1 = torch.where(denom > 0, 2.0 * diag / denom.clamp_min(1), torch.zeros_like(denom))
    pa = diag.sum() / total
    pe = (cm.sum(dim=0) * cm.sum(dim=1)).sum() / (total * total)
    return {"accuracy": diag.sum() * 100.0 / total, "f1": f1,
            "kappa": (pa - pe) / (1.0 - pe).clamp_min(1e-12), "confusion_matrix": cm}
