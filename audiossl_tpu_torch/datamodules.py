"""The downstream data facade (PyTorch port of
``audiossl_tpu/datamodules.py``; reference ``audiossl/lightning/
datamodules.py``: DownstreamDataModule, get_inmemory_datamodule,
EmbeddingExtractor, without Lightning).

``DownstreamDataModule`` resolves a registered dataset into its three
split loaders with the padding and batching of the probes;
``InMemoryDataModule`` wraps cached embedding arrays for the linear-probe
phase; ``EmbeddingExtractor`` runs a frozen extractor over a loader
through ``downstream.embedding.extract_split`` (lightning/utils.py:8: one
batched function, the mel kernel K1 on the card for the ATST extractors).
"""
from __future__ import annotations

import dataclasses
import os
from typing import Callable

import numpy as np

from audiossl_tpu_torch.datasets import get_dataset
from audiossl_tpu_torch.datasets.pipeline import BatchLoader


class ConcatDataset:
    """torch-style concatenation of map-style datasets."""

    def __init__(self, datasets):
        self.datasets = list(datasets)
        self._offsets = []
        total = 0
        for d in self.datasets:
            total += len(d)
            self._offsets.append(total)

    def __len__(self):
        return self._offsets[-1] if self._offsets else 0

    def __getitem__(self, i):
        prev = 0
        for d, off in zip(self.datasets, self._offsets):
            if i < off:
                return d[i - prev]
            prev = off
        raise IndexError(i)


@dataclasses.dataclass
class DownstreamDataModule:
    data_path: str
    dataset_name: str
    batch_size: int = 64
    train_len_s: float = 12.0
    sr: int = 16000
    fold: int = 0
    loader_kwargs: dict = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        self.info = get_dataset(self.dataset_name)
        self.pad_samples = int(self.train_len_s * self.sr)

    def _loader(self, split: str, shuffle: bool) -> BatchLoader:
        kw = dict(fold=self.fold) if self.info.num_folds > 1 else {}
        ds = self.info.creator(self.data_path, split=split, **kw)
        if self.dataset_name == "audioset" and split == "train":
            # the reference concatenates the unbalanced and balanced train
            # sets (lightning/datamodules.py:173-182)
            b_path = os.path.join(self.data_path, "../audioset_b")
            if os.path.exists(os.path.join(b_path, "train.ards")):
                ds = ConcatDataset([
                    ds, get_dataset("audioset_b").creator(b_path,
                                                          split="train")])
        return BatchLoader(ds, self.batch_size, pad_samples=self.pad_samples,
                           shuffle=shuffle, drop_last=shuffle,
                           **self.loader_kwargs)

    def train_dataloader(self):
        return self._loader("train", True)

    def val_dataloader(self):
        return self._loader("valid", False)

    def test_dataloader(self):
        return self._loader("test", False)

    @property
    def num_labels(self):
        return self.info.num_labels

    @property
    def multi_label(self):
        return self.info.multi_label


class InMemoryDataModule:
    """Cached-embedding splits (reference get_inmemory_datamodule,
    datamodules.py:10-33)."""

    def __init__(self, x_train, y_train, x_val, y_val, x_test, y_test,
                 batch_size: int = 1024):
        self.splits = {
            "train": (np.asarray(x_train), np.asarray(y_train)),
            "valid": (np.asarray(x_val), np.asarray(y_val)),
            "test": (np.asarray(x_test), np.asarray(y_test)),
        }
        self.batch_size = batch_size

    def iter_split(self, split: str, shuffle: bool = False, seed: int = 0):
        x, y = self.splits[split]
        order = np.arange(len(x))
        if shuffle:
            np.random.RandomState(seed).shuffle(order)
        for i in range(0, len(x), self.batch_size):
            sel = order[i: i + self.batch_size]
            yield x[sel], y[sel]


class EmbeddingExtractor:
    """Runs a frozen extractor ``extract_fn(wav, valid) -> [B, D]`` over a
    loader and returns the embeddings and labels as numpy arrays."""

    def __init__(self, extract_fn: Callable):
        self.extract_fn = extract_fn

    def extract(self, loader):
        from audiossl_tpu_torch.downstream.embedding import extract_split

        return extract_split(self.extract_fn, loader)
