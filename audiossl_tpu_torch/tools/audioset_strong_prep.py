"""AudioSet-strong preprocessing pipeline without pandas (port of
``scripts/audioset_strong_prep.py``; reference
``scripts/dataset_preprocess/audioset_strong/``: gen_tsv.py,
common_label_filtrate.py, intersected_event_filtrate.py, orchestrated by
audioset_strong.bash).

Subcommands:
  gen_tsv     raw AudioSet-strong csv -> DCASE-format tsv + durations
  common      keep only labels present in BOTH train and eval tsv,
              write common_labels.txt (407 classes in the reference)
  merge       merge overlapping same-class events per file

Usage:
    python -m audiossl_tpu_torch.tools.audioset_strong_prep gen_tsv \\
        --csv audioset_train_strong.tsv --out train/meta.tsv
    python -m audiossl_tpu_torch.tools.audioset_strong_prep common \\
        --train train/meta.tsv --eval eval/meta.tsv \\
        --labels_out common_labels.txt
    python -m audiossl_tpu_torch.tools.audioset_strong_prep merge \\
        --tsv train/meta.tsv

The files are byte for byte those the JAX script writes with pandas on the
same input. What that takes, here with ``csv`` and numpy:

* the raw file's delimiter is sniffed from its first line
  (``csv.Sniffer``, as pandas' python engine does for ``sep=None``);
  every later line is read with that delimiter, ``"`` quoting and
  blank lines skipped;
* a column's type is inferred as pandas infers it: the fields pandas
  reads as missing (empty, ``NA``, ``nan``, ``null``, ...) are NaN, a
  column whose other fields are all integers is int64 (float64 if it has
  a NaN), all numbers float64, anything else text; a number is read as
  pandas' default parser reads it, at most 17 digits gathered in a
  double and scaled by a power of ten, so not always the nearest double
  (``0.30000000000000004`` reads as 0.3); the raw columns are found by
  their lower-cased name, else by position, and a missing segment id or
  label stays missing (written as an empty field, as pandas 3's
  ``astype(str)`` keeps NaN);
* numbers are written as pandas writes them: int64 as ``str(int)``,
  float64 by numpy's shortest round-trip form (``2.0``, ``1.5``,
  ``1e-05``), NaN as an empty field; text through ``csv.writer`` with
  tab as the delimiter and minimal quoting;
* ``_durations.tsv`` (named by replacing every ``.tsv`` in ``--out``)
  holds each file's largest offset, in sorted filename order, floored at
  ``--min_duration``;
* ``common`` writes the sorted intersection one label per line with a
  trailing newline and filters both files in place, keeping row order
  and each column's type (integer times stay integers);
* ``merge`` sorts on filename, label and onset (a stable sort, NaN onsets
  last), joins events where ``onset <= cur_off``, and writes the groups
  in sorted order; rows with a missing filename or label belong to no
  group and are dropped, as pandas' ``groupby`` drops them.

Not followed: the header's own quirks (duplicate or empty column names,
rows longer than the header), pandas' boolean columns (``true`` written
back as ``True``) and integers beyond int64. Runs on the host alone: no
tensor, so no ``--device``.
"""
from __future__ import annotations

import argparse
import csv
import io
import math
import os

import numpy as np

# the strings pandas' read_csv takes for a missing value by default
NA_VALUES = frozenset({
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
    "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a",
    "nan", "null"})
NAN = float("nan")


def _isna(v) -> bool:
    return isinstance(v, float) and math.isnan(v)


def _as_int(s: str):
    if "_" in s:  # Python reads 1_000; pandas does not
        return None
    try:
        return int(s)
    except ValueError:
        return None


_POW10 = [float(f"1e{k}") for k in range(309)]


def _as_float(s: str):
    """``s`` as pandas' default ("high" precision) parser reads a float,
    or None: at most 17 significant digits gathered in a double, times or
    over a power of ten, so not always the nearest double
    (``0.30000000000000004`` reads as 0.3)."""
    t = s.strip(" \t\n\r\f\v")
    i, n = 0, len(t)
    negative = i < n and t[i] == "-"
    i += i < n and t[i] in "+-"
    number, exponent, digits = 0.0, 0, 0
    while i < n and t[i] in "0123456789":
        if digits < 17:
            number = number * 10.0 + (ord(t[i]) - 48)
            digits += 1
        else:
            exponent += 1
        i += 1
    if i < n and t[i] == ".":
        i += 1
        decimals = 0
        while digits < 17 and i < n and t[i] in "0123456789":
            number = number * 10.0 + (ord(t[i]) - 48)
            digits += 1
            decimals += 1
            i += 1
        while i < n and t[i] in "0123456789":
            i += 1
        exponent -= decimals
    if digits == 0:
        return None
    if negative:
        number = -number
    if i < n and t[i] in "eE":
        j = i + 1
        neg_exp = j < n and t[j] == "-"
        j += j < n and t[j] in "+-"
        e, e_digits = 0, 0
        while e_digits < 17 and j < n and t[j] in "0123456789":
            e = e * 10 + ord(t[j]) - 48
            e_digits += 1
            j += 1
        if e_digits:
            exponent += -e if neg_exp else e
            i = j
    if i != n:
        return None
    if exponent > 308:  # out of range: inf, and an unsigned zero
        return math.copysign(math.inf, number) if number else 0.0
    if exponent > 0:
        return number * _POW10[exponent]
    if exponent < -308:
        if exponent < -616:
            return 0.0 * number
        return number / _POW10[-308 - exponent] / _POW10[308]
    return number / _POW10[-exponent]


class Column:
    """One column's values as pandas types them: ``kind`` "int", "float"
    or "str"; missing values are NaN."""

    def __init__(self, values, kind):
        self.values, self.kind = values, kind

    @classmethod
    def parse(cls, fields):
        na = [f in NA_VALUES for f in fields]
        present = [f for f, m in zip(fields, na) if not m]
        if present and all(_as_int(f) is not None for f in present):
            if any(na):
                return cls([NAN if m else float(int(f))
                            for f, m in zip(fields, na)], "float")
            return cls([int(f) for f in fields], "int")
        if present and all(_as_float(f) is not None for f in present):
            return cls([NAN if m else _as_float(f)
                        for f, m in zip(fields, na)], "float")
        if not present and fields:
            return cls([NAN] * len(fields), "float")
        return cls([NAN if m else f for f, m in zip(fields, na)], "str")

    def take(self, rows):
        return Column([self.values[i] for i in rows], self.kind)

    def as_float(self):
        return Column([float(v) for v in self.values], "float")

    def formatted(self):
        """The fields ``DataFrame.to_csv`` writes for these values."""
        if self.kind == "float":
            text = np.asarray(self.values, dtype=np.float64).astype(str)
            return ["" if _isna(v) else t for v, t in zip(self.values, text)]
        return ["" if _isna(v) else str(v) for v in self.values]


def read_table(path, sep=None):
    """``pd.read_csv(path, sep=sep)`` (``sep=None``: the python engine's
    sniffed delimiter) -> (column names, {name: Column})."""
    with open(path, newline="") as f:
        text = f.read()
    if sep is None:  # the first line, as pandas' python engine reads it
        sep = csv.Sniffer().sniff(
            io.StringIO(text, newline="").readline()).delimiter
    rows = [r for r in csv.reader(io.StringIO(text, newline=""),
                                  delimiter=sep, quotechar='"',
                                  doublequote=True, strict=True)
            if len(r) > 1 or (r and r[0].strip())]
    names = rows[0]
    body = rows[1:]
    for r in body:
        r.extend([""] * (len(names) - len(r)))
    return names, {n: Column.parse([r[i] for r in body])
                   for i, n in enumerate(names)}


def write_table(path, names, cols):
    """``DataFrame.to_csv(path, sep="\\t", index=False)``."""
    fields = [cols[n].formatted() for n in names]
    with open(path, "w", newline="") as f:
        w = csv.writer(f, delimiter="\t", lineterminator="\n",
                       quoting=csv.QUOTE_MINIMAL, quotechar='"',
                       doublequote=True)
        w.writerow(names)
        w.writerows(zip(*fields))


def _str_of(col: Column):
    """``Series.astype(str)``: missing values stay missing."""
    return Column([v if _isna(v) else str(v) for v in col.values], "str")


def gen_tsv(args):
    """Raw csv columns: segment_id, start_time_seconds,
    end_time_seconds, label -> tsv filename/onset/offset/event_label
    with a durations tsv."""
    names, cols = read_table(args.csv)
    lower = {c.lower(): c for c in names}
    seg = lower.get("segment_id", names[0])
    on = lower.get("start_time_seconds", names[1])
    off = lower.get("end_time_seconds", names[2])
    lab = lower.get("label", names[3])
    filename = Column([v if _isna(v) else v + ".wav"
                       for v in _str_of(cols[seg]).values], "str")
    out = {"filename": filename, "onset": cols[on].as_float(),
           "offset": cols[off].as_float(),
           "event_label": _str_of(cols[lab])}
    order = ["filename", "onset", "offset", "event_label"]
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    write_table(args.out, order, out)
    longest = {}
    for fname, o in zip(filename.values, out["offset"].values):
        if _isna(fname):
            continue
        if fname not in longest or _isna(longest[fname]):
            longest[fname] = o
        elif not _isna(o):
            longest[fname] = max(longest[fname], o)
    files = sorted(longest)
    dur = np.maximum(np.asarray([longest[f] for f in files],
                                dtype=np.float64), args.min_duration)
    write_table(args.out.replace(".tsv", "_durations.tsv"),
                ["filename", "duration"],
                {"filename": Column(files, "str"),
                 "duration": Column([float(d) for d in dur], "float")})
    print(f"{args.out}: {len(filename.values)} events, {len(files)} files")


def common(args):
    """Intersect label sets of train/eval and filter both tsvs
    (reference common_label_filtrate.py)."""
    tr_names, tr = read_table(args.train, sep="\t")
    ev_names, ev = read_table(args.eval, sep="\t")
    labels = sorted(set(tr["event_label"].values)
                    & set(ev["event_label"].values))
    with open(args.labels_out, "w") as f:
        f.write("\n".join(labels) + "\n")
    keep = set(labels)
    for path, names, cols in ((args.train, tr_names, tr),
                              (args.eval, ev_names, ev)):
        rows = [i for i, v in enumerate(cols["event_label"].values)
                if v in keep]
        write_table(path, names, {n: cols[n].take(rows) for n in names})
    print(f"{len(labels)} common labels")


def _sort_key(v):
    """Ascending with NaN last, as ``sort_values`` orders a column."""
    return (1, 0) if _isna(v) else (0, v)


def merge(args):
    """Merge overlapping same-class events per file (reference
    intersected_event_filtrate.py)."""
    names, cols = read_table(args.tsv, sep="\t")
    fn, on, off, lab = (cols[n].values for n in
                        ("filename", "onset", "offset", "event_label"))
    n = len(fn)
    order = sorted(range(n), key=lambda i: (_sort_key(fn[i]),
                                            _sort_key(lab[i]),
                                            _sort_key(on[i])))
    rows = []
    cur = None  # (filename, label, onset, offset) of the open event
    for i in order:
        if _isna(fn[i]) or _isna(lab[i]):
            continue
        if cur is not None and (cur[0], cur[1]) == (fn[i], lab[i]) \
                and on[i] <= cur[3]:
            cur = (*cur[:3], max(cur[3], off[i]))
            continue
        if cur is not None:
            rows.append(cur)
        cur = (fn[i], lab[i], on[i], off[i])
    if cur is not None:
        rows.append(cur)
    kinds = {"onset": cols["onset"].kind, "offset": cols["offset"].kind}
    out = {"filename": Column([r[0] for r in rows], "str"),
           "onset": Column([r[2] for r in rows], kinds["onset"]),
           "offset": Column([r[3] for r in rows], kinds["offset"]),
           "event_label": Column([r[1] for r in rows], "str")}
    write_table(args.tsv, ["filename", "onset", "offset", "event_label"],
                out)
    print(f"{args.tsv}: {n} -> {len(rows)} events after merging")


def build_parser():
    p = argparse.ArgumentParser("audioset_strong_prep",
                                description=__doc__.split("\n\n")[0])
    sub = p.add_subparsers(dest="cmd", required=True)
    g = sub.add_parser("gen_tsv")
    g.add_argument("--csv", required=True)
    g.add_argument("--out", required=True)
    g.add_argument("--min_duration", type=float, default=10.0)
    c = sub.add_parser("common")
    c.add_argument("--train", required=True)
    c.add_argument("--eval", required=True)
    c.add_argument("--labels_out", required=True)
    m = sub.add_parser("merge")
    m.add_argument("--tsv", required=True)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    {"gen_tsv": gen_tsv, "common": common, "merge": merge}[args.cmd](args)


if __name__ == "__main__":
    main()
