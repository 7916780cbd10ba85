"""SED datasets: DCASE-style strong / weak sets and the mixed-batch loader
(the port's own copy of ``audiossl_tpu/datasets/sed.py``).

Reference ``datasets/dcase_utils/datasets.py`` (StronglyAnnotatedSet /
WeakSet / UnlabeledSet: TSV-driven, padded or cropped to 10 s, strong
labels on the frame grid), ``datasets/dcase_utils/sampler.py``
(ConcatDatasetSampler: every batch fixed counts from each source),
``datasets/dcase.py`` (the DCASE sets from its config) and ``datasets/as_strong.py``
(407-class AudioSet-strong). The TSVs are read with the ``csv`` module
(the JAX package uses pandas): rows are dicts of strings, an empty field
is a missing value. The weak train / validation split draws the rows
pandas' ``sample(frac, random_state)`` draws.
"""
from __future__ import annotations

import csv
import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from audiossl_tpu_torch.datasets.audio_io import load_wav
from audiossl_tpu_torch.datasets.registry import register_dataset
from audiossl_tpu_torch.sed.encoder import ManyHotEncoder

DCASE_CLASSES = [
    "Alarm_bell_ringing", "Blender", "Cat", "Dishes", "Dog",
    "Electric_shaver_toothbrush", "Frying", "Running_water", "Speech",
    "Vacuum_cleaner",
]


def read_tsv(path: str) -> List[Dict[str, str]]:
    """A tab-separated file with a header -> one dict per row."""
    with open(path, newline="") as f:
        return list(csv.DictReader(f, delimiter="\t"))


def dcase_encoder(audio_len: float = 10.0, frame_hop: int = 160,
                  net_pooling: int = 4, fs: int = 16000,
                  labels: Optional[Sequence[str]] = None) -> ManyHotEncoder:
    """The DCASE grid: 10 s, a 10 ms hop and net pooling 4 (patch_w): 250
    output frames (reference utils_dcase/conf)."""
    return ManyHotEncoder(labels or DCASE_CLASSES, audio_len=audio_len,
                          frame_len=1024, frame_hop=frame_hop,
                          net_pooling=net_pooling, fs=fs)


def _padded(path: str, fs: int, pad_to: int) -> np.ndarray:
    wav = load_wav(path, fs)
    out = np.zeros(pad_to, np.float32)
    n = min(len(wav), pad_to)
    out[:n] = wav[:n]
    return out


class StronglyAnnotatedSet:
    """TSV rows (filename, onset, offset, event_label) -> one example a
    file, yielding (wav [pad_to * fs], strong [n_frames, C], filename)."""

    def __init__(self, audio_folder: str, tsv_entries: Sequence[Dict],
                 encoder: ManyHotEncoder, pad_to: float = 10.0,
                 fs: int = 16000):
        self.encoder = encoder
        self.fs = fs
        self.pad_to = int(pad_to * fs)
        ex: Dict[str, dict] = {}
        for r in tsv_entries:
            if not r.get("filename"):
                continue
            e = ex.setdefault(r["filename"], {
                "path": os.path.join(audio_folder, r["filename"]),
                "events": []})
            if r.get("onset") not in (None, ""):
                e["events"].append((r.get("event_label") or None,
                                    float(r["onset"]), float(r["offset"])))
        self.examples = list(ex.values())
        self.filenames = list(ex.keys())

    def __len__(self):
        return len(self.examples)

    def __getitem__(self, i):
        e = self.examples[i]
        wav = _padded(e["path"], self.fs, self.pad_to)
        strong = self.encoder.encode_strong_df(e["events"]).astype(np.float32)
        return wav, strong, self.filenames[i]


class WeakSet:
    """TSV rows (filename, event_labels comma-joined) -> strong-shaped
    labels active over every frame (the weak-pooled loss masks frames)."""

    def __init__(self, audio_folder: str, tsv_entries: Sequence[Dict],
                 encoder: ManyHotEncoder, pad_to: float = 10.0,
                 fs: int = 16000):
        self.encoder = encoder
        self.fs = fs
        self.pad_to = int(pad_to * fs)
        self.examples = [
            (os.path.join(audio_folder, r["filename"]),
             str(r["event_labels"]).split(","), r["filename"])
            for r in tsv_entries]

    def __len__(self):
        return len(self.examples)

    def __getitem__(self, i):
        path, labels, fname = self.examples[i]
        out = _padded(path, self.fs, self.pad_to)
        strong = self.encoder.encode_strong_df(labels).astype(np.float32)
        return out, strong, fname


class UnlabeledSet(WeakSet):
    def __init__(self, audio_folder: str, encoder: ManyHotEncoder,
                 pad_to: float = 10.0, fs: int = 16000):
        rows = [{"filename": f, "event_labels": ""}
                for f in sorted(os.listdir(audio_folder))]
        super().__init__(audio_folder, rows, encoder, pad_to, fs)


class MixedBatchLoader:
    """Every batch holds fixed counts from each source (reference
    ConcatDatasetSampler, sampler.py:7-101), e.g. [128 synth, 128 weak];
    shorter sources cycle. Yields dicts of wav, valid (the padded length),
    strong, source (the source's index per row) and filenames.

    ``mode`` picks the source whose length sets the epoch (reference
    ``batch_len_index``: steps per epoch = ``len(datasets[mode]) //
    batch_sizes[mode]``; the DCASE config uses 1, the weak set,
    ``conf/frame_40.yaml``). Epoch e (``set_epoch``; 0 until it is called)
    shuffles with ``RandomState(seed + e)``."""

    def __init__(self, datasets: Sequence, batch_sizes: Sequence[int],
                 shuffle: bool = True, seed: int = 0, mode: int = 0):
        assert len(datasets) == len(batch_sizes)
        assert 0 <= mode < len(datasets)
        self.datasets = list(datasets)
        self.batch_sizes = list(batch_sizes)
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 0
        self.mode = mode

    def __len__(self):
        return max(len(self.datasets[self.mode])
                   // self.batch_sizes[self.mode], 1)

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __iter__(self):
        rng = np.random.RandomState(self.seed + self.epoch)
        orders = []
        for ds in self.datasets:
            o = np.arange(len(ds))
            if self.shuffle:
                rng.shuffle(o)
            orders.append(o)
        pos = [0] * len(self.datasets)
        for _ in range(len(self)):
            wavs, strongs, fnames, src_ids = [], [], [], []
            for si, (ds, bs) in enumerate(zip(self.datasets,
                                              self.batch_sizes)):
                for _ in range(bs):
                    if pos[si] >= len(orders[si]):
                        pos[si] = 0
                        if self.shuffle:
                            rng.shuffle(orders[si])
                    item = ds[int(orders[si][pos[si]])]
                    pos[si] += 1
                    wavs.append(item[0])
                    strongs.append(item[1])
                    fnames.append(item[2])
                    src_ids.append(si)
            yield {
                "wav": np.stack(wavs).astype(np.float32),
                "valid": np.full(len(wavs), wavs[0].shape[0], np.int32),
                "strong": np.stack(strongs),
                "source": np.asarray(src_ids, np.int32),
                "filenames": fnames,
            }


def load_dcase_split(audio_folder: str, tsv_path: str, kind: str,
                     encoder: Optional[ManyHotEncoder] = None,
                     pad_to: float = 10.0):
    """kind in {'strong', 'weak', 'unlabeled'}."""
    enc = encoder or dcase_encoder(audio_len=pad_to)
    if kind == "unlabeled":
        return UnlabeledSet(audio_folder, enc, pad_to=pad_to)
    cls = StronglyAnnotatedSet if kind == "strong" else WeakSet
    return cls(audio_folder, read_tsv(tsv_path), enc, pad_to=pad_to)


def _weak_train_val_split(path, weak_split: float, seed: int):
    """Reference datasets/dcase.py:121-133: a ``weak_split`` share of the
    weak TSV's rows (0.9, seed 42) trains, the rest is the weak
    VALIDATION set. pandas' ``sample(frac=weak_split, random_state=seed)``:
    ``RandomState(seed).choice(n, round(weak_split * n), replace=False)``,
    in that order; the rest keep the file's order."""
    rows = read_tsv(os.path.join(path, "weak_train/meta.tsv"))
    n = len(rows)
    take = np.random.RandomState(seed).choice(n, size=round(weak_split * n),
                                              replace=False)
    rest = np.setdiff1d(np.arange(n), take)
    return [rows[i] for i in take], [rows[i] for i in rest]


@register_dataset("dcase", multi_label=True, num_labels=10)
def create_dcase(path, split="train", weak_split: float = 0.9,
                 seed: int = 42, encoder: Optional[ManyHotEncoder] = None):
    """Layout: {synth_train, weak_train, synth_val, strong_val}, each with
    audio/ and meta.tsv (the DCASE config's paths, reference
    datasets/dcase.py:80-181).

    train -> (synth_train strong, weak_train's train share);
    valid -> (synth_val strong, weak_train's validation share);
    test  -> strong_val."""
    enc = encoder or dcase_encoder()
    if split == "train":
        synth = load_dcase_split(os.path.join(path, "synth_train/audio"),
                                 os.path.join(path, "synth_train/meta.tsv"),
                                 "strong", enc)
        weak_rows, _ = _weak_train_val_split(path, weak_split, seed)
        weak = WeakSet(os.path.join(path, "weak_train/audio"), weak_rows,
                       enc)
        return synth, weak
    if split in ("valid", "val"):
        synth_val = load_dcase_split(
            os.path.join(path, "synth_val/audio"),
            os.path.join(path, "synth_val/meta.tsv"), "strong", enc)
        _, weak_val_rows = _weak_train_val_split(path, weak_split, seed)
        weak_val = WeakSet(os.path.join(path, "weak_train/audio"),
                           weak_val_rows, enc)
        return synth_val, weak_val
    return load_dcase_split(os.path.join(path, "strong_val/audio"),
                            os.path.join(path, "strong_val/meta.tsv"),
                            "strong", enc)


def load_as_strong_labels(label_file: str) -> List[str]:
    """The AudioSet-strong label list, 407 for the published
    ``common_labels.txt`` (reference as_strong_utils/as_strong_dict.py)."""
    with open(label_file) as f:
        return [line.strip() for line in f if line.strip()]


@register_dataset("as_strong", multi_label=True, num_labels=407)
def create_as_strong(path, split="train",
                     encoder: Optional[ManyHotEncoder] = None):
    """Layout: common_labels.txt and {train, val, eval}, each with audio/
    and meta.tsv."""
    labels = load_as_strong_labels(os.path.join(path, "common_labels.txt"))
    enc = encoder or dcase_encoder(labels=labels)
    sub = {"train": "train", "valid": "val", "val": "val",
           "test": "eval"}[split]
    return load_dcase_split(os.path.join(path, sub, "audio"),
                            os.path.join(path, sub, "meta.tsv"),
                            "strong", enc)


def write_synthetic_sed(path: str, splits: Dict[str, int],
                        labels: Sequence[str], weak_splits: Sequence[str] = (),
                        duration_splits: Sequence[str] = (), seed: int = 0,
                        seconds: float = 10.0) -> None:
    """A seeded SED tree under ``path``: ``common_labels.txt`` and, for
    each split, ``<split>/audio/*.wav`` (16 kHz 16-bit clips of
    ``seconds``: quiet noise and, for each of 1 to 3 events, the tone of
    its class, one frequency a class from 200 Hz to 7 kHz, between its
    onset and offset) and ``<split>/meta.tsv``: a row per event (filename,
    onset, offset, event_label), or for ``weak_splits`` a row per clip
    (filename, event_labels); ``duration_splits`` also get
    ``durations.tsv``."""
    rng = np.random.RandomState(seed)
    fs = 16000
    C = len(labels)
    freqs = 200.0 * 35.0 ** (np.arange(C) / max(C - 1, 1))
    n = int(seconds * fs)
    t = np.arange(n, dtype=np.float32) / fs
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "common_labels.txt"), "w") as f:
        f.write("".join(f"{lab}\n" for lab in labels))
    from scipy.io import wavfile

    for split, count in splits.items():
        audio = os.path.join(path, split, "audio")
        os.makedirs(audio, exist_ok=True)
        weak = split in weak_splits
        rows = []
        for i in range(count):
            name = f"{split}_{i:05d}.wav"
            wav = rng.randn(n).astype(np.float32) * 0.01
            events = []
            for _ in range(rng.randint(1, 4)):
                c = int(rng.randint(C))
                on = round(float(rng.uniform(0, seconds - 0.5)), 3)
                off = round(min(seconds, on + float(rng.uniform(
                    0.3, seconds / 2))), 3)
                a, b = int(on * fs), int(off * fs)
                wav[a:b] += 0.3 * np.sin(2 * np.pi * freqs[c] * t[a:b])
                events.append((on, off, labels[c]))
            wavfile.write(os.path.join(audio, name), fs, np.clip(
                wav * 32767, -32768, 32767).astype(np.int16))
            if weak:
                rows.append([name, ",".join(dict.fromkeys(
                    e[2] for e in events))])
            else:
                rows += [[name, *e] for e in events]
        header = (["filename", "event_labels"] if weak
                  else ["filename", "onset", "offset", "event_label"])
        _write_tsv(os.path.join(path, split, "meta.tsv"), header, rows)
        if split in duration_splits:
            _write_tsv(os.path.join(path, split, "durations.tsv"),
                       ["filename", "duration"],
                       [[f"{split}_{i:05d}.wav", seconds]
                        for i in range(count)])


def _write_tsv(path: str, header, rows) -> None:
    with open(path, "w", newline="") as f:
        w = csv.writer(f, delimiter="\t", lineterminator="\n")
        w.writerow(header)
        w.writerows(rows)
