"""Intersection-based SED metrics (PyTorch port of
``audiossl_tpu/sed/metrics.py``; reference
``downstream/utils_psds_eval/gpu_decode.py:85-229``, SEDMetrics).

Events are contiguous runs of OR(pred, truth) per (clip, class); each
event scores ratio = sum(pred) / sum(truth) inside the event and is
exactly one of TP (thd <= ratio < 1/thd), FP (ratio >= 1/thd) or FN
(ratio < thd). Events get ids from a cumulative sum over their starts, and
per-event sums come from ``scatter_add_`` into a fixed number of slots, on
the predictions' device (JAX: ``segment_sum``). The counts are sums of
zeros and ones in f32, exact in any order. The accumulators, the weak F1
and the AUC helpers run on the host with numpy, as in JAX.
"""
from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch


def _event_sums(active: torch.Tensor, *values: torch.Tensor):
    """active: [R, T] bool (R = B*C rows). Returns (is_event [R, E],
    per-event sums of each of ``values`` [R, E] in f32) with E = T//2 + 2
    slots: every possible run, and a last slot for inactive frames."""
    R, T = active.shape
    E = T // 2 + 2
    prev = torch.cat([torch.zeros_like(active[:, :1]), active[:, :-1]], -1)
    starts = active & ~prev
    eid = torch.cumsum(starts, dim=-1) - 1  # [R, T], -1 before the first
    ids = torch.where(active, eid.clamp(0, E - 1), E - 1)
    n_events = starts.sum(-1)
    is_event = torch.arange(E, device=active.device)[None, :] < \
        n_events[:, None]
    is_event[:, E - 1] = False
    sums = [torch.zeros(R, E, dtype=torch.float32, device=active.device)
            .scatter_add_(1, ids, v.to(torch.float32)) for v in values]
    return is_event, sums


def intersection_stats(preds: torch.Tensor, truths: torch.Tensor,
                       thd: float = 0.7
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                  torch.Tensor]:
    """preds/truths: [B, C, T] binary. Returns per-(clip, class) event
    counts summed over events: tp, fp, fn and n_events [B, C] (f32)."""
    B, C, T = preds.shape
    p = preds.reshape(B * C, T) > 0.5
    t = truths.reshape(B * C, T) > 0.5
    is_event, (p_sum, t_sum) = _event_sums(p | t, p, t)
    ratio = p_sum / (t_sum + 1e-7)
    longer = ratio >= thd
    shorter = ratio < 1.0 / thd
    tp = longer & shorter & is_event
    fp = longer & ~shorter & is_event
    fn = shorter & ~longer & is_event

    def count(m):
        return m.sum(-1).reshape(B, C).to(torch.float32)

    return count(tp), count(fp), count(fn), count(is_event)


def true_negative_stats(preds: torch.Tensor, neg_truths: torch.Tensor
                        ) -> torch.Tensor:
    """TN events: runs of neg_truth fully covered by ``preds``
    (reference compute_tn, gpu_decode.py:127-148); ``preds`` here is the
    NEGATED hard prediction. -> [B, C] counts."""
    B, C, T = preds.shape
    p = preds.reshape(B * C, T) > 0.5
    n = neg_truths.reshape(B * C, T) > 0.5
    is_event, (p_sum, n_sum) = _event_sums(n, p & n, n)
    tn = (p_sum >= n_sum - 1e-6) & is_event
    return tn.sum(-1).reshape(B, C).to(torch.float32)


def f1_from_stats(tp, fp, fn, eps: float = 1e-7) -> torch.Tensor:
    """Macro F1 over classes from accumulated per-class counts [C]."""
    f1 = tp / (tp + 0.5 * (fp + fn) + eps)
    return torch.nan_to_num(f1).mean()


def clip_avg_f1(preds, truths, thd: float = 0.5) -> torch.Tensor:
    """Per-clip F1 averaged over the batch (reference compute_avg_f1,
    gpu_decode.py:150-161: the DCASE validation objective)."""
    tp, fp, fn, n_ev = intersection_stats(preds, truths, thd)
    tp_clip = tp.sum(-1)
    all_clip = n_ev.sum(-1)
    f = tp_clip / (0.5 * tp_clip + 0.5 * all_clip)
    return torch.nan_to_num(f).mean()


class SEDMetrics:
    """Accumulates per-class intersection counts over batches; the counts
    are computed on the predictions' device, summed on the host."""

    def __init__(self, intersection_thd: float = 0.5):
        self.thd = intersection_thd
        self.reset()

    def reset(self):
        self.tp = 0.0
        self.fp = 0.0
        self.fn = 0.0
        self.tn = 0.0

    def accumulate(self, preds, truths):
        preds = torch.as_tensor(preds)
        tp, fp, fn, _ = intersection_stats(
            preds, torch.as_tensor(truths, device=preds.device), self.thd)
        self.tp = self.tp + tp.cpu().numpy().sum(0)
        self.fp = self.fp + fp.cpu().numpy().sum(0)
        self.fn = self.fn + fn.cpu().numpy().sum(0)

    def macro_f1(self) -> float:
        f1 = self.tp / (self.tp + 0.5 * (self.fp + self.fn) + 1e-7)
        out = float(np.mean(np.nan_to_num(f1)))
        self.reset()
        return out


class WeakF1Accumulator:
    """Clip-level (weak-label) multilabel macro F1 at threshold 0.5, as
    torchmetrics ``F1Score(num_labels=C, average="macro",
    task="multilabel")`` computes the reference's validation objective
    (``utils_dcase/model_dcase.py:116-120,175``): scores binarized at 0.5,
    per-class tp/fp/fn accumulated over batches, ``f1_c = 2tp / (2tp + fp
    + fn)`` (0 when the denominator is 0), the mean over ALL classes."""

    def __init__(self, threshold: float = 0.5):
        self.threshold = threshold
        self.reset()

    def reset(self):
        self.tp = 0.0
        self.fp = 0.0
        self.fn = 0.0

    def accumulate(self, scores, targets):
        """scores [B, C] in [0, 1]; targets [B, C] in {0, 1}."""
        pred = np.asarray(scores) >= self.threshold
        t = np.asarray(targets) > 0.5
        self.tp = self.tp + (pred & t).sum(0).astype(np.float64)
        self.fp = self.fp + (pred & ~t).sum(0).astype(np.float64)
        self.fn = self.fn + (~pred & t).sum(0).astype(np.float64)

    def macro_f1(self) -> float:
        denom = 2 * self.tp + self.fp + self.fn
        f1 = np.where(denom > 0, 2 * self.tp / np.maximum(denom, 1), 0.0)
        out = float(np.mean(f1))
        self.reset()
        return out


def auc_from_curves(tpr: np.ndarray, fpr: np.ndarray) -> float:
    """Mean per-class trapezoid AUC of (fpr, tpr) curves [n_thds, C]."""
    aucs = []
    for c in range(tpr.shape[1]):
        x = fpr[::-1, c]
        y = tpr[::-1, c]
        ok = ~(np.isnan(x) | np.isnan(y))
        if ok.sum() < 2:
            continue
        aucs.append(np.trapezoid(y[ok], x[ok]))
    return float(np.mean(aucs)) if aucs else 0.0


def d_prime(auc: float) -> float:
    from scipy import stats

    return float(stats.norm().ppf(auc) * math.sqrt(2.0))
