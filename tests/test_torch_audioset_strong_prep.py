"""``python -m audiossl_tpu_torch.tools.audioset_strong_prep`` against
``scripts/audioset_strong_prep.py`` (CPU): on copies of the same inputs,
every file each subcommand writes is byte for byte the JAX script's, and
so is every line it prints. The JAX script runs with pandas; the port
runs with pandas and JAX blocked. One process each runs every case (the
subcommands as ``python -m`` runs them, through ``runpy``)."""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("pandas")

ROOT = Path(__file__).resolve().parents[1]
HEADER = ("segment_id", "start_time_seconds", "end_time_seconds", "label")


def raw(rows, sep=",", header=HEADER):
    """A raw AudioSet-strong file: a header and one line per row."""
    return "".join(sep.join(r) + "\n" for r in [header, *rows])


def tsv(rows):
    """A DCASE-format tsv written by hand."""
    return raw(rows, "\t", ("filename", "onset", "offset", "event_label"))


TRAIN = [("a", "0.0", "2.0", "Dog"), ("a", "1.5", "3.0", "Dog"),
         ("b", "2.0", "4.0", "Cat")]
EVAL = [("c", "0.25", "1.0", "Dog"), ("c", "0.5", "9.5", "Bird")]
# each case: its files, and the steps run on them in order
CASES = {
    # the rows tests/test_components.py writes
    "components_rows": {"train.csv": raw(TRAIN), "eval.csv": raw(EVAL)},
    "tab_separated": {"train.csv": raw(TRAIN, "\t"),
                      "eval.csv": raw(EVAL, "\t")},
    "upper_case_headers": {
        "train.csv": raw(TRAIN, header=tuple(h.upper() for h in HEADER)),
        "eval.csv": raw(EVAL, header=("Segment_ID", "Start_Time_Seconds",
                                      "End_Time_Seconds", "Label"))},
    "headers_by_position": {
        "train.csv": raw(TRAIN, header=("ytid", "t0", "t1", "mid")),
        "eval.csv": raw(EVAL, header=("a", "b", "c", "d"))},
    "integer_times": {
        "train.csv": raw([("a", "0", "2", "Dog"), ("a", "2", "5", "Dog"),
                          ("b", "1", "3", "Cat")]),
        "eval.csv": raw([("c", "0", "1", "Dog")]),
        # read back as integers, they stay integers in common and merge
        "int_train.tsv": tsv([("a.wav", "0", "2", "Dog"),
                              ("a.wav", "1", "4", "Dog"),
                              ("b.wav", "3", "7", "Cat")]),
        "int_eval.tsv": tsv([("c.wav", "5", "6", "Dog")])},
    "quoted_comma_label": {
        "train.csv": raw([("a", "0.0", "2.0", '"Dog, bark"'),
                          ("a", "1.0", "3.0", '"Dog, bark"'),
                          ("b", "0.5", "1.5", "Cat")]),
        "eval.csv": raw([("c", "0.0", "1.0", '"Dog, bark"'),
                         ("c", "0.0", "1.0", "Cat")])},
    "unsorted_rows": {
        "train.csv": raw([("z", "5.0", "6.0", "Dog"),
                          ("a", "3.0", "4.0", "Dog"),
                          ("a", "0.0", "1.0", "Dog"),
                          ("b", "0.1", "0.2", "Cat"),
                          ("a", "0.5", "3.5", "Dog"),
                          ("a", "0.2", "0.4", "Ant")]),
        "eval.csv": raw([("y", "1.0", "2.0", "Dog"),
                         ("x", "0.0", "1.0", "Ant")])},
    "touching_events": {
        "train.csv": raw([("a", "0.0", "1.25", "Dog"),
                          ("a", "1.25", "2.5", "Dog"),
                          ("a", "2.5", "2.5", "Dog"),
                          ("a", "2.75", "3.0", "Dog")]),
        "eval.csv": raw([("b", "1.0", "2.0", "Dog"),
                         ("b", "2.0", "3.0", "Dog")])},
    "shorter_than_min_duration": {
        "train.csv": raw([("a", "0.0", "2.0", "Dog"),
                          ("b", "0.0", "12.5", "Dog"),
                          ("c", "9.0", "10.0", "Dog")]),
        "eval.csv": raw([("d", "0.0", "0.5", "Dog")])},
    # fields pandas reads as missing: empty and "NA" times and segment ids
    "missing_fields": {
        "train.csv": raw([("a", "", "2.0", "Dog"),
                          ("NA", "0.0", "1.0", "Dog"),
                          ("b", "0.5", "", "Dog"),
                          ("b", "0.0", "3.0", "Cat")]),
        "eval.csv": raw([("c", "0.0", "1.0", "Dog"),
                         ("c", "1.0", "NA", "Cat")])},
    # pandas reads at most 17 digits into a double: not the nearest one
    "seventeen_digits": {
        "train.csv": raw([("a", "0.1", "0.30000000000000004", "Dog"),
                          ("a", "1e-5", "0.33333333333333331", "Dog")]),
        "eval.csv": raw([("b", "0.0", "1.0", "Dog")])},
}
STEPS = [
    ["gen_tsv", "--csv", "train.csv", "--out", "train/meta.tsv"],
    ["gen_tsv", "--csv", "eval.csv", "--out", "eval/meta.tsv",
     "--min_duration", "1.5"],
    ["common", "--train", "train/meta.tsv", "--eval", "eval/meta.tsv",
     "--labels_out", "common_labels.txt"],
    ["merge", "--tsv", "train/meta.tsv"],
    ["merge", "--tsv", "eval/meta.tsv"],
]
INT_STEPS = [
    ["common", "--train", "int_train.tsv", "--eval", "int_eval.tsv",
     "--labels_out", "int_labels.txt"],
    ["merge", "--tsv", "int_train.tsv"],
]

# runs each case's steps in its directory; prints one JSON object of
# {case: [[exit code, printed text], ...]}
RUNNER = r"""
import contextlib, io, json, os, runpy, sys
which, cases = sys.argv[1], json.loads(sys.argv[2])
if which == "port":
    for m in ("pandas", "jax", "jaxlib", "flax"):
        sys.modules[m] = None
out = {}
for case, (path, steps) in cases.items():
    os.chdir(path)
    out[case] = []
    for step in steps:
        buf = io.StringIO()
        code = 0
        sys.argv = ["audioset_strong_prep", *step]
        try:
            with contextlib.redirect_stdout(buf):
                if which == "port":
                    runpy.run_module(
                        "audiossl_tpu_torch.tools.audioset_strong_prep",
                        run_name="__main__")
                else:
                    runpy.run_path(os.path.join(
                        os.environ["REPO"], "scripts",
                        "audioset_strong_prep.py"), run_name="__main__")
        except SystemExit as e:
            code = e.code
        out[case].append([code, buf.getvalue()])
bad = [m for m in sys.modules if m.split(".")[0] == "audiossl_tpu"]
assert which == "jax" or not bad, bad
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both implementations over every case: {which: (root, printed)}."""
    res = {}
    for which in ("jax", "port"):
        root = tmp_path_factory.mktemp(which)
        cases = {}
        for case, files in CASES.items():
            d = root / case
            d.mkdir()
            for name, text in files.items():
                (d / name).write_text(text)
            steps = STEPS + (INT_STEPS if "int_train.tsv" in files else [])
            cases[case] = [str(d), steps]
        r = subprocess.run(
            [sys.executable, "-c", RUNNER, which, json.dumps(cases)],
            cwd=ROOT, capture_output=True, text=True, timeout=120,
            env={**os.environ, "REPO": str(ROOT),
                 "PYTHONPATH": str(ROOT)})
        assert r.returncode == 0, r.stderr
        res[which] = (root, json.loads(r.stdout.splitlines()[-1]))
    return res


def _files(d):
    return {str(p.relative_to(d)): p.read_bytes()
            for p in sorted(d.rglob("*")) if p.is_file()}


@pytest.mark.parametrize("case", list(CASES))
def test_files_and_lines_equal_jaxs(runs, case):
    (jroot, jout), (proot, pout) = runs["jax"], runs["port"]
    assert pout[case] == jout[case]
    assert all(code == 0 for code, _ in jout[case]), jout[case]
    want, got = _files(jroot / case), _files(proot / case)
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name] == want[name], (name, got[name], want[name])
    # every subcommand wrote what it should
    assert {"train/meta.tsv", "train/meta_durations.tsv", "eval/meta.tsv",
            "eval/meta_durations.tsv", "common_labels.txt"} <= set(got)


def test_cases_show_what_they_name(runs):
    """The cases reach the behaviour they are named for, on the port's
    files (equal to JAX's by the test above)."""
    root = runs["port"][0]

    def lines(case, name):
        return (root / case / name).read_text().splitlines()

    assert lines("components_rows", "train/meta.tsv") == [
        "filename\tonset\toffset\tevent_label", "a.wav\t0.0\t3.0\tDog"]
    assert lines("components_rows", "common_labels.txt") == ["Dog"]
    assert lines("integer_times", "int_train.tsv") == [
        "filename\tonset\toffset\tevent_label", "a.wav\t0\t4\tDog"]
    assert lines("touching_events", "train/meta.tsv")[1:] == [
        "a.wav\t0.0\t2.5\tDog", "a.wav\t2.75\t3.0\tDog"]
    assert lines("shorter_than_min_duration",
                 "train/meta_durations.tsv")[1:] == [
        "a.wav\t10.0", "b.wav\t12.5", "c.wav\t10.0"]
    assert lines("quoted_comma_label", "common_labels.txt") == [
        "Cat", "Dog, bark"]
    assert lines("seventeen_digits", "train/meta.tsv")[1] == \
        "a.wav\t1e-05\t0.3333333333333333\tDog"
    assert [ln.split("\t")[0] for ln in lines(
        "unsorted_rows", "train/meta.tsv")[1:]] == ["a.wav"] * 2 + [
        "z.wav"]
