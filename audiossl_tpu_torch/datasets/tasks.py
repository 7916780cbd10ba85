"""Downstream task datasets over the original on-disk layouts (the port's
own copy of ``audiossl_tpu/datasets/tasks.py``).

Equivalents of the reference dataset classes (reference
``audiossl/datasets/{byol_a,voxceleb1,iemocap,librispeech}.py``) reading
the same metadata files, with scipy wav IO. The metadata CSVs are read
with the ``csv`` module (the JAX package uses pandas): string labels map to
ints by first occurrence, as ``df.label.unique()`` orders them. Every class
is a map-style dataset yielding ``(waveform float32 [n], label)`` for
``BatchLoader``.
"""
from __future__ import annotations

import csv
import glob
import json
import os
from typing import Dict, List, Optional, Sequence

from audiossl_tpu_torch.datasets.audio_io import load_wav


class _WavDataset:
    """Shared base: list of (path, label)."""

    sr = 16000

    def __init__(self, files: Sequence[str], labels: Sequence[int]):
        self.files = list(files)
        self.labels = list(labels)

    def __len__(self):
        return len(self.files)

    def __getitem__(self, i: int):
        return load_wav(self.files[i], self.sr), self.labels[i]


def _read_task_rows(meta_dir: str, task: str) -> List[Dict[str, object]]:
    """BYOL-A meta csv: columns file_name, label[, split] -> one dict per
    row, the labels mapped to ints by first occurrence (reference
    byol_a.py:30-35)."""
    with open(os.path.join(meta_dir, f"{task}.csv"), newline="") as f:
        rows = list(csv.DictReader(f))
    ids: Dict[str, int] = {}
    for r in rows:
        r["label"] = ids.setdefault(r["label"], len(ids))
    return rows


class Nsynth(_WavDataset):
    """NSynth-11 instrument family (reference byol_a.py:182-209):
    splits train/valid/test from the csv's split column."""

    def __init__(self, root: str, meta_dir: str, split: str = "train"):
        rows = _read_task_rows(meta_dir, "nsynth")
        split = {"val": "valid"}.get(split, split)
        sel = [r for r in rows if r["split"] == split]
        files = [os.path.join(root, r["file_name"]) for r in sel]
        super().__init__(files, [r["label"] for r in sel])


class Urbansound8k(_WavDataset):
    """US8K 10-fold (reference byol_a.py:212-251): fold from the path
    'audio/foldXX/...'; train = the 9 other folds, valid == test == the
    held-out fold (the reference evaluates on the same fold it selects
    on in the n-fold loop)."""

    def __init__(self, root: str, meta_dir: str, split: str = "train",
                 fold: int = 0):
        rows = _read_task_rows(meta_dir, "us8k")

        def fold_of(r):
            return int(r["file_name"].split("/")[1][4:]) - 1

        if split == "train":
            sel = [r for r in rows if fold_of(r) != fold]
        else:  # valid/test: the held-out fold
            sel = [r for r in rows if fold_of(r) == fold]
        files = [os.path.join(root, r["file_name"]) for r in sel]
        super().__init__(files, [r["label"] for r in sel])


class SpeechCommandsV2(_WavDataset):
    """SPCV2-35 (reference scripts/dataset_preprocess/speech_command_v2.py):
    validation/testing file lists; everything else is train."""

    LABELS = [
        "backward", "bed", "bird", "cat", "dog", "down", "eight", "five",
        "follow", "forward", "four", "go", "happy", "house", "learn",
        "left", "marvin", "nine", "no", "off", "on", "one", "right",
        "seven", "sheila", "six", "stop", "three", "tree", "two", "up",
        "visual", "wow", "yes", "zero",
    ]

    def __init__(self, root: str, split: str = "train"):
        def read_list(name):
            with open(os.path.join(root, name)) as f:
                return set(l.strip() for l in f if l.strip())

        val = read_list("validation_list.txt")
        test = read_list("testing_list.txt")
        lab2i = {l: i for i, l in enumerate(self.LABELS)}
        files, labels = [], []
        for lab in self.LABELS:
            for p in sorted(glob.glob(os.path.join(root, lab, "*.wav"))):
                rel = os.path.relpath(p, root)
                in_val = rel in val
                in_test = rel in test
                if (split == "train" and not in_val and not in_test) or \
                   (split in ("valid", "val") and in_val) or \
                   (split == "test" and in_test):
                    files.append(p)
                    labels.append(lab2i[lab])
        super().__init__(files, labels)


class SpeakerClassifiDataset(_WavDataset):
    """VoxCeleb1 speaker-id (reference voxceleb1.py:26-149): splits from
    iden_split.txt (1=train 2=valid 3=test), label = int(id) - 10001."""

    def __init__(self, root: str, meta_file: Optional[str] = None,
                 split: str = "train"):
        meta_file = meta_file or os.path.join(root, "iden_split.txt")
        want = {"train": "1", "valid": "2", "val": "2", "test": "3"}[split]
        files, labels = [], []
        with open(meta_file) as f:
            for line in f:
                parts = line.split()
                if len(parts) != 2 or parts[0] != want:
                    continue
                rel = parts[1]
                cands = glob.glob(os.path.join(root, "*", "wav", rel))
                path = cands[0] if cands else os.path.join(root, "wav", rel)
                files.append(path)
                labels.append(int(rel.split("/")[0][2:]) - 10001)
        super().__init__(files, labels)


class IEMOCAPDataset(_WavDataset):
    """IEMOCAP 4-class emotion (reference iemocap.py:21-66): JSON meta
    {'meta_data': [{'path', 'label'}...]}, resampled to 16k."""

    LABELS = ["neu", "hap", "ang", "sad"]

    def __init__(self, root: str, meta_file: str):
        with open(meta_file) as f:
            meta = json.load(f)["meta_data"]
        lab2i = {l: i for i, l in enumerate(self.LABELS)}
        files = [os.path.join(root, m["path"]) for m in meta]
        labels = [lab2i[m["label"]] if isinstance(m["label"], str)
                  else int(m["label"]) for m in meta]
        super().__init__(files, labels)


class LibriSpeechDataset(_WavDataset):
    """Pretrain-only concat of LibriSpeech subsets; label always 0
    (reference librispeech.py:8-23)."""

    def __init__(self, root: str,
                 subsets=("train-clean-100", "train-clean-360",
                          "train-other-500")):
        files: List[str] = []
        for s in subsets:
            files.extend(sorted(
                glob.glob(os.path.join(root, s, "**", "*.flac"),
                          recursive=True) +
                glob.glob(os.path.join(root, s, "**", "*.wav"),
                          recursive=True)))
        super().__init__(files, [0] * len(files))
