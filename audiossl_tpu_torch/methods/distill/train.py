"""ATST-C2F distillation (PyTorch port of ``audiossl_tpu/methods/distill/
train.py``; reference ``methods/atstframe/train_distill.py``). So far only
its class-balanced sampling weights, which the finetuning driver also uses
for AudioSet (``downstream/train_finetune.py``); the distillation method
and CLI come with the distill slice.
"""
from __future__ import annotations

import numpy as np


def class_balance_weights(dataset, num_labels: int) -> np.ndarray:
    """Per-record sampling weights: 1 / sqrt(class frequency) summed over a
    record's active labels (reference ``test_sampler.py``'s
    ``weights_labels``), at least 1e-8. Reads every record's label through
    ``dataset[i]``, as JAX's does."""
    counts = np.zeros(num_labels)
    labels = []
    for i in range(len(dataset)):
        _, y = dataset[i][:2]
        y = np.asarray(y)
        labels.append(y)
        counts += y
    counts = np.maximum(counts, 1.0)
    w = np.array([(y / np.sqrt(counts)).sum() for y in labels])
    return np.maximum(w, 1e-8)
