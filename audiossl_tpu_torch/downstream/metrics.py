"""Evaluation metrics: top-1 accuracy and macro mAP (numpy only).

The port's own copy of ``audiossl_tpu/downstream/metrics.py`` (reference
``methods/atst/downstream/utils.py:142-178``): sklearn's
``average_precision_score`` per class with NaN classes dropped, or top-1
accuracy, over predictions accumulated on the host.
"""
from __future__ import annotations

from typing import List

import numpy as np


def top1_accuracy(logits: np.ndarray, targets: np.ndarray) -> float:
    return float((logits.argmax(-1) == targets).mean())


def average_precision(scores: np.ndarray, targets: np.ndarray) -> float:
    """Binary AP for one class, sklearn ``average_precision_score``
    semantics (the step-wise integral of precision at each recall change);
    NaN for a class with no positive."""
    order = np.argsort(-scores, kind="stable")
    t = targets[order]
    npos = t.sum()
    if npos == 0:
        return float("nan")
    tp = np.cumsum(t)
    precision = tp / np.arange(1, len(t) + 1)
    return float(np.sum(precision * (t / npos)))


def mean_average_precision(scores: np.ndarray, targets: np.ndarray) -> float:
    """Macro mAP over classes, NaN classes dropped (0.0 when none is
    left)."""
    aps = [average_precision(scores[:, c], targets[:, c])
           for c in range(scores.shape[1])]
    aps = [a for a in aps if not np.isnan(a)]
    return float(np.mean(aps)) if aps else 0.0


class Metric:
    """Accumulate (pred, target) batches; compute mAP or ACC."""

    def __init__(self, mode: str = "ACC"):
        if mode not in ("ACC", "mAP"):
            raise ValueError(f"unknown metric {mode!r}")
        self.mode = mode
        self._preds: List[np.ndarray] = []
        self._targets: List[np.ndarray] = []

    def update(self, pred, target):
        self._preds.append(np.asarray(pred))
        self._targets.append(np.asarray(target))

    def compute(self) -> float:
        preds = np.concatenate(self._preds)
        targets = np.concatenate(self._targets)
        if self.mode == "mAP":
            return mean_average_precision(preds, targets)
        return top1_accuracy(preds, targets)

    def reset(self):
        self._preds, self._targets = [], []
