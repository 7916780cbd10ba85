"""Dataset -> .ards pack converters (port of ``scripts/dataset2ards.py``;
reference ``scripts/dataset_preprocess/dataset2lmdb.py`` / ``audioset.py``
/ ``speech_command_v2.py``), on the port's ``datasets/`` (``load_wav``,
``PackedWriter``, ``write_synthetic_pack``). The CSV files are read with
the ``csv`` module (no pandas); ``lmdb`` and ``pyarrow`` are imported by
the ``lmdb`` subcommand alone. Runs on the host; ``--device`` is checked
as every tool's is.

Usage:
  # folder of wavs + csv (columns: file_name, label[, split])
  python -m audiossl_tpu_torch.tools.dataset2ards folder --audio_root DIR \\
      --csv META.csv --out OUT_DIR [--split-col split]

  # AudioSet-style: csv with ytid -> label indices (multi-hot, 527)
  python -m audiossl_tpu_torch.tools.dataset2ards audioset --audio_root DIR \\
      --csv unbalanced.csv --labels class_labels_indices.csv --out OUT

  # reference LMDB store -> ards (needs the lmdb package)
  python -m audiossl_tpu_torch.tools.dataset2ards lmdb --lmdb PATH/train.lmdb \\
      --out OUT

  # synthetic data for tests/benchmarks
  python -m audiossl_tpu_torch.tools.dataset2ards synth --out OUT --n 1000
"""
from __future__ import annotations

import argparse
import csv
import os

import numpy as np

from audiossl_tpu_torch.datasets.audio_io import load_wav
from audiossl_tpu_torch.datasets.packed import (PackedWriter,
                                                write_synthetic_pack)
from audiossl_tpu_torch.tools import add_device_flag, device_of


def _unique(values):
    """The distinct values in order of first appearance (pandas'
    ``unique``)."""
    return list(dict.fromkeys(values))


def convert_folder(args):
    with open(args.csv, newline="") as f:
        rows = list(csv.DictReader(f))
    cols = rows[0].keys() if rows else ()
    split_col = args.split_col if args.split_col in cols else None
    labels = {l: i for i, l in enumerate(_unique(r["label"] for r in rows))}
    os.makedirs(args.out, exist_ok=True)
    splits = (sorted(_unique(r[split_col] for r in rows)) if split_col
              else ["train"])
    written = {}
    for split in splits:
        srows = [r for r in rows if r[split_col] == split] if split_col \
            else rows
        name = {"val": "valid"}.get(split, split)
        with PackedWriter(os.path.join(args.out, f"{name}.ards")) as w:
            for row in srows:
                wav = load_wav(os.path.join(args.audio_root,
                                            row["file_name"]), args.sr)
                w.add((wav * 32767).astype(np.int16),
                      int(labels[row["label"]]), args.sr)
        print(f"{name}: {len(srows)} records")
        written[name] = len(srows)
    return written


def convert_audioset(args):
    with open(args.labels, newline="") as f:
        lab = list(csv.DictReader(f))  # index,mid,display_name
    mid2idx = {r["mid"]: int(r["index"]) for r in lab}
    n_cls = len(lab)
    with open(args.csv, newline="") as f:
        seg = [r for r in csv.reader(
            (line for line in f if not line.startswith("#")),
            skipinitialspace=True, quotechar='"') if r]
    os.makedirs(args.out, exist_ok=True)
    n_written = 0
    with PackedWriter(os.path.join(args.out,
                                   f"{args.split}.ards")) as w:
        for ytid, _start, _end, positive in (r[:4] for r in seg):
            path = os.path.join(args.audio_root, f"{ytid}.wav")
            if not os.path.exists(path):
                continue
            y = np.zeros(n_cls, np.float32)
            for mid in str(positive).split(","):
                mid = mid.strip().strip('"')
                if mid in mid2idx:
                    y[mid2idx[mid]] = 1.0
            wav = load_wav(path, args.sr)
            w.add((wav * 32767).astype(np.int16), y, args.sr)
            n_written += 1
    print(f"{args.split}: {n_written} records")
    return {args.split: n_written}


def convert_lmdb(args):
    try:
        import lmdb
        import pyarrow as pa
    except ImportError as e:
        raise SystemExit(f"lmdb conversion needs lmdb+pyarrow: {e}")
    env = lmdb.open(args.lmdb, readonly=True, lock=False)
    os.makedirs(args.out, exist_ok=True)
    split = os.path.basename(args.lmdb).replace(".lmdb", "")
    with env.begin() as txn, PackedWriter(
            os.path.join(args.out, f"{split}.ards")) as w:
        n = 0
        for key, value in txn.cursor():
            if key in (b"__len__", b"__keys__"):
                continue
            wav, label = pa.deserialize(value)
            wav = np.asarray(wav).reshape(-1)
            w.add(wav, label if np.isscalar(label)
                  else np.asarray(label, np.float32), args.sr)
            n += 1
    print(f"{split}: {n} records")
    return {split: n}


def build_parser():
    p = argparse.ArgumentParser("dataset2ards",
                                description=__doc__.split("\n\n")[0])
    add_device_flag(p)
    sub = p.add_subparsers(dest="cmd", required=True)

    f = sub.add_parser("folder")
    f.add_argument("--audio_root", required=True)
    f.add_argument("--csv", required=True)
    f.add_argument("--out", required=True)
    f.add_argument("--split-col", default="split")
    f.add_argument("--sr", type=int, default=16000)

    a = sub.add_parser("audioset")
    a.add_argument("--audio_root", required=True)
    a.add_argument("--csv", required=True)
    a.add_argument("--labels", required=True)
    a.add_argument("--out", required=True)
    a.add_argument("--split", default="train")
    a.add_argument("--sr", type=int, default=16000)

    l = sub.add_parser("lmdb")  # noqa: E741
    l.add_argument("--lmdb", required=True)
    l.add_argument("--out", required=True)
    l.add_argument("--sr", type=int, default=16000)

    s = sub.add_parser("synth")
    s.add_argument("--out", required=True)
    s.add_argument("--n", type=int, default=1000)
    s.add_argument("--split", default="train")
    s.add_argument("--num_labels", type=int, default=527)
    s.add_argument("--multi_label", action="store_true")
    return p


def main(argv=None) -> dict:
    """Returns the records written by split."""
    args = build_parser().parse_args(argv)
    device_of(args)
    if args.cmd == "folder":
        return convert_folder(args)
    if args.cmd == "audioset":
        return convert_audioset(args)
    if args.cmd == "lmdb":
        return convert_lmdb(args)
    write_synthetic_pack(args.out, args.split, args.n,
                         num_labels=args.num_labels,
                         multi_label=args.multi_label)
    print(f"wrote {args.n} synthetic records")
    return {args.split: args.n}


if __name__ == "__main__":
    main()
