"""SED prediction decoding: threshold, median smoothing, events (PyTorch
port of ``audiossl_tpu/sed/decode.py``; reference
``downstream/utils_psds_eval/gpu_decode.py:18-311``).

Hard thresholding and a same-padded median filter along time (scipy's
reflect padding) run on the scores' device for any number of thresholds at
once, in groups of thresholds whose sorted windows stay under
``WINDOW_BYTES``; the results do not depend on the grouping. The event
extraction runs on the host with numpy and returns event records
``(event_label, onset, offset, filename)``, where the JAX package returns a
pandas DataFrame with those columns.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

# the sorted windows (values and int64 indices) of one group of thresholds
WINDOW_BYTES = 1 << 30

Event = Tuple[str, float, float, str]


def _reflect_pad_1d(x: torch.Tensor, pl: int, pr: int) -> torch.Tensor:
    """scipy.ndimage-style reflect padding on the last axis (the
    reference's 'scripy_pad', gpu_decode.py:58-68): the edge values
    repeated, then the interior reflected."""
    left = x[..., :pl].flip(-1) if pl else x[..., :0]
    right = x[..., -pr:].flip(-1) if pr else x[..., :0]
    return torch.cat([left, x, right], dim=-1)


def median_filter_1d(x: torch.Tensor, k: int) -> torch.Tensor:
    """Median filter along the last (time) axis, 'same' output length. An
    even window averages its two central order statistics, as the
    reference's MedianPool2d.median does (gpu_decode.py:39-56);
    ``torch.median`` would take the lower one."""
    pw = max(k - 1, 0)
    pl, pr = pw // 2, pw - pw // 2
    windows = _reflect_pad_1d(x, pl, pr).unfold(-1, k, 1)  # [..., T, k]
    s = torch.sort(windows, dim=-1).values
    mid = k // 2
    if k % 2 == 1:
        return s[..., mid]
    return 0.5 * (s[..., mid - 1] + s[..., mid])


def decode_preds(strong_preds: torch.Tensor, thresholds: Sequence[float],
                 median_window: int = 7) -> torch.Tensor:
    """[B, C, T] sigmoid scores -> smoothed hard predictions
    [n_thresholds, B, C, T] (or [B, C, T] for a single threshold) on the
    scores' device (reference decode_preds, gpu_decode.py:231-245)."""
    thds = torch.tensor([float(t) for t in thresholds],
                        dtype=strong_preds.dtype, device=strong_preds.device)
    per = strong_preds.numel() * max(median_window, 1) * (
        strong_preds.element_size() + 8)
    group = max(1, WINDOW_BYTES // max(per, 1))
    out = []
    for i in range(0, len(thds), group):
        t = thds[i:i + group]
        hard = (strong_preds[None] > t[:, None, None, None]).to(
            strong_preds.dtype)
        out.append(median_filter_1d(hard, median_window))
    smooth = torch.cat(out) if len(out) > 1 else out[0]
    if len(thds) == 1:
        return smooth[0]
    return smooth


def preds_to_events(hard_preds, filenames: Sequence[str],
                    encoder) -> List[Event]:
    """[B, C, T] binarized (smoothed) predictions -> event records
    (event_label, onset, offset, filename), by clip, then class, then
    time, as ``encoder.decode_strong`` lists each clip's (reference
    batched_decode_preds, gpu_decode.py:248-311)."""
    h = np.asarray(hard_preds) > 0.5
    B, C, _ = h.shape
    pad = np.zeros((B, C, 1), np.int8)
    changes = np.diff(np.concatenate([pad, h.astype(np.int8), pad], -1),
                      axis=-1)
    b, c, s = np.nonzero(changes == 1)
    e = np.nonzero(changes == -1)[2]
    on = encoder._frame_to_time(s).tolist()
    off = encoder._frame_to_time(e).tolist()
    return [(encoder.labels[ci], o, f, filenames[bi])
            for bi, ci, o, f in zip(b.tolist(), c.tolist(), on, off)]


def batched_decode_preds(strong_preds, filenames, encoder,
                         thresholds=(0.5,), median_filter: int = 7
                         ) -> Dict[float, List[Event]]:
    """-> {threshold: event records} for a batch of scores [B, C, T]."""
    smooth = decode_preds(torch.as_tensor(strong_preds), list(thresholds),
                          median_filter)
    if len(thresholds) == 1:
        smooth = smooth[None]
    smooth = smooth.cpu().numpy()
    return {thd: preds_to_events(smooth[i], filenames, encoder)
            for i, thd in enumerate(thresholds)}
