"""Top-k checkpoints on a validation metric (PyTorch port of
``TopKKeeper`` in ``audiossl_tpu/training/checkpoint.py``).

Reference: Lightning ``ModelCheckpoint(save_top_k=10, monitor="val_*",
mode="max")`` in the downstream drivers
(``methods/atst/downstream/train_freeze.py:117-124``). Each ``update``
saves a state dict with ``torch.save`` under ``<dir>/top/<tag>/state.pt``
when it ranks in the current top 10 and removes the worst; ``index.json``
(the JAX package's layout: ``{"mode": "max", "scores": {tag: metric}}``)
makes the set survive a restart. The JAX package saves orbax directories
instead.
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Dict, Mapping

import torch

STATE_FILE = "state.pt"
TOP_K = 10


class TopKKeeper:
    """The ``TOP_K`` saved states with the highest validation metric."""

    def __init__(self, directory: str):
        self.dir = os.path.abspath(os.path.expanduser(
            os.path.join(directory, "top")))
        os.makedirs(self.dir, exist_ok=True)
        self._index_path = os.path.join(self.dir, "index.json")
        self._index: Dict[int, float] = {}
        if os.path.exists(self._index_path):
            self._index = read_topk_index(self._index_path)

    def _write_index(self):
        with open(self._index_path, "w") as f:
            json.dump({"mode": "max",
                       "scores": {str(k): v
                                  for k, v in self._index.items()}}, f)

    def update(self, metric: float, tag: int,
               state: Mapping[str, torch.Tensor]) -> bool:
        """Save ``state`` under ``tag`` (epoch or step) if it makes the top
        k. Returns True when saved."""
        if len(self._index) >= TOP_K:
            worst_tag = min(self._index, key=self._index.__getitem__)
            if metric < self._index[worst_tag]:
                return False
            shutil.rmtree(os.path.join(self.dir, str(worst_tag)),
                          ignore_errors=True)
            del self._index[worst_tag]
        target = os.path.join(self.dir, str(tag))
        if os.path.exists(target):  # a re-run of the same epoch
            shutil.rmtree(target, ignore_errors=True)
        os.makedirs(target)
        torch.save(dict(state), os.path.join(target, STATE_FILE))
        self._index[int(tag)] = float(metric)
        self._write_index()
        return True


def read_topk_index(index_path: str) -> Dict[int, float]:
    """-> {tag: metric} of an ``index.json`` the keeper wrote."""
    with open(index_path) as f:
        data = json.load(f)
    return {int(k): float(v) for k, v in data["scores"].items()}
