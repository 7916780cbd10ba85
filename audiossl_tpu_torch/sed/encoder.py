"""Many-hot strong/weak label encoder, host side (the port's own copy of
``audiossl_tpu/sed/encoder.py``; reference
``datasets/dcase_utils/encoder.py:8-230``).

Events given as (event_label, onset, offset) seconds are rasterized onto a
fixed frame grid; decoding turns frame activations back into event lists.
The grid is the reference's: ``n_frames = (audio_len * fs // frame_hop) //
net_pooling``, onsets floored, offsets ceiled, and the ``"empty"`` sentinel
all -1. The JAX package takes pandas DataFrames; this copy takes events as
a list of ``(event_label, onset, offset)`` records or of dicts with those
keys, labels as a list of strings, or ``"empty"``. A label that is None,
NaN or ``""`` marks a row without an event.
"""
from __future__ import annotations

import math
from typing import List, Sequence

import numpy as np


def is_label(lab) -> bool:
    """A present label: not None, not NaN, not empty."""
    if lab is None or (isinstance(lab, float) and math.isnan(lab)):
        return False
    return lab != ""


def _event(e):
    """A record or dict -> (event_label, onset, offset)."""
    if isinstance(e, dict):
        return e["event_label"], e.get("onset"), e.get("offset")
    return e[0], e[1], e[2]


class ManyHotEncoder:
    def __init__(self, labels: Sequence[str], audio_len: float,
                 frame_len: int, frame_hop: int, net_pooling: int = 1,
                 fs: int = 16000):
        self.labels = list(labels)
        self.audio_len = audio_len
        self.frame_len = frame_len
        self.frame_hop = frame_hop
        self.fs = fs
        self.net_pooling = net_pooling
        self.n_frames = int(int(audio_len * fs / frame_hop) / net_pooling)

    # ------------------------------------------------------------- #
    def _time_to_frame(self, time):
        frame = time * self.fs / self.frame_hop
        return np.clip(frame / self.net_pooling, 0, self.n_frames)

    def _frame_to_time(self, frame):
        t = frame * self.net_pooling * self.frame_hop / self.fs
        return np.clip(t, 0, self.audio_len)

    # ------------------------------------------------------------- #
    def encode_weak(self, labels) -> np.ndarray:
        """"empty", comma-joined labels, a list of labels or a list of
        events -> [n_classes]."""
        if isinstance(labels, str):
            if labels == "empty":
                return np.zeros(len(self.labels)) - 1
            labels = labels.split(",")
        y = np.zeros(len(self.labels))
        for lab in labels:
            if not isinstance(lab, str) and lab is not None:
                lab = _event(lab)[0]
            if is_label(lab):
                y[self.labels.index(lab)] = 1
        return y

    def encode_strong_df(self, label_df) -> np.ndarray:
        """"empty", a list of events (records or dicts) or a list of labels
        (active over every frame) -> [n_frames, n_classes]."""
        if isinstance(label_df, str) and label_df == "empty":
            return np.zeros((self.n_frames, len(self.labels))) - 1
        y = np.zeros((self.n_frames, len(self.labels)))
        for e in label_df:
            if isinstance(e, str) or e is None:
                if e and is_label(e):
                    y[:, self.labels.index(e)] = 1
                continue
            lab, on, off = _event(e)
            if not is_label(lab):
                continue
            i = self.labels.index(lab)
            onset = int(self._time_to_frame(float(on)))
            offset = int(np.ceil(self._time_to_frame(float(off))))
            y[onset:offset, i] = 1
        return y

    def decode_strong(self, labels: np.ndarray) -> List[list]:
        """[n_frames, n_classes] activations -> [[label, onset_s,
        offset_s], ...] (reference encoder.py:173-195)."""
        out = []
        for i, cls_name in enumerate(self.labels):
            col = np.asarray(labels[:, i] > 0.5, np.int8)
            changes = np.diff(np.concatenate([[0], col, [0]]))
            starts = np.where(changes == 1)[0]
            ends = np.where(changes == -1)[0]
            for s, e in zip(starts, ends):
                out.append([cls_name, self._frame_to_time(s),
                            self._frame_to_time(e)])
        return out

    def decode_weak(self, labels: np.ndarray) -> List[str]:
        return [self.labels[i] for i in np.where(np.asarray(labels) > 0.5)[0]]
