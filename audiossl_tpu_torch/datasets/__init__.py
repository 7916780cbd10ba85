"""Datasets: the registry and its creators (the port's own copy of
``audiossl_tpu/datasets/__init__.py``; reference
``audiossl/datasets/__init__.py``).

The registered names and metadata are the reference's (voxceleb1 1251,
us8k 10 labels in 10 folds, nsynth 11, spcv2 35, iemocap 4 in 5 folds,
librispeech, fsd50k 200 multi-label, audioset_b / audioset 527
multi-label, dcase 10 and as_strong 407 multi-label). Bulk corpora
(audioset, fsd50k) read ``.ards`` packs (``packed.py``); task datasets read
their original layouts (``tasks.py``), the SED datasets theirs
(``sed.py``). Nothing here imports pandas or PyYAML.
"""
from __future__ import annotations

import os

from audiossl_tpu_torch.datasets.registry import (
    DatasetInfo,
    get_dataset,
    list_all_datasets,
    register_dataset,
)
from audiossl_tpu_torch.datasets.packed import (
    PackedAudioDataset,
    PackedReader,
    PackedWriter,
    write_synthetic_pack,
)
from audiossl_tpu_torch.datasets.pipeline import BatchLoader
from audiossl_tpu_torch.datasets.tasks import (
    IEMOCAPDataset,
    LibriSpeechDataset,
    Nsynth,
    SpeakerClassifiDataset,
    SpeechCommandsV2,
    Urbansound8k,
)


@register_dataset("voxceleb1", multi_label=False, num_labels=1251)
def create_voxceleb1(path, split="train"):
    return SpeakerClassifiDataset(path, split=split)


@register_dataset("us8k", multi_label=False, num_labels=10, num_folds=10)
def create_us8k(path, split="train", fold=0):
    return Urbansound8k(path, os.path.join(path, "metadata"), split=split,
                        fold=fold)


@register_dataset("nsynth", multi_label=False, num_labels=11)
def create_nsynth(path, split="train"):
    return Nsynth(path, os.path.join(path, "metadata"), split=split)


@register_dataset("spcv2", multi_label=False, num_labels=35)
def create_spcv2(path, split="train"):
    return SpeechCommandsV2(path, split=split)


@register_dataset("iemocap", multi_label=False, num_labels=4, num_folds=5)
def create_iemocap(path, split="train", fold=0):
    """5-fold by session: meta_data_<split>_session<fold+1>.json if
    present, else meta_data_<split>.json (single split)."""
    cand = os.path.join(path, f"meta_data_{split}_session{fold + 1}.json")
    default = os.path.join(path, f"meta_data_{split}.json")
    return IEMOCAPDataset(path, cand if os.path.exists(cand) else default)


@register_dataset("librispeech", multi_label=False, num_labels=1)
def create_librispeech(path, split="train"):
    return LibriSpeechDataset(path)


def _packed(path, split):
    return PackedAudioDataset(path, split={"val": "valid"}.get(split, split))


@register_dataset("fsd50k", multi_label=True, num_labels=200)
def create_fsd50k(path, split="train"):
    return _packed(path, split)


@register_dataset("audioset_b", multi_label=True, num_labels=527)
def create_audioset_b(path, split="train"):
    return _packed(path, split)


@register_dataset("audioset", multi_label=True, num_labels=527)
def create_audioset(path, split="train"):
    return _packed(path, split)


# registers "dcase" and "as_strong"
from audiossl_tpu_torch.datasets import sed  # noqa: E402,F401

__all__ = [
    "DatasetInfo",
    "get_dataset",
    "list_all_datasets",
    "register_dataset",
    "PackedAudioDataset",
    "PackedReader",
    "PackedWriter",
    "write_synthetic_pack",
    "BatchLoader",
    "Nsynth",
    "Urbansound8k",
    "SpeechCommandsV2",
    "SpeakerClassifiDataset",
    "IEMOCAPDataset",
    "LibriSpeechDataset",
]
