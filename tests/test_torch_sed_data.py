"""The SED data layer against the JAX package (CPU).

* the weak train / validation split read with ``csv`` equals pandas'
  ``sample(frac=0.9, random_state=42)`` split, for several row counts;
* ``MixedBatchLoader`` over the same DCASE sets gives bit-equal batches
  to JAX's over 2 epochs (wav, valid, strong, source, filenames), with the
  epoch's length set by either source (``mode`` 0 and 1);
* ``create_dcase`` and ``create_as_strong`` on a small written tree give
  JAX's examples, item for item, and the registry's metadata.
"""
import os

import numpy as np
import pytest

pytest.importorskip("jax")
pd = pytest.importorskip("pandas")

from audiossl_tpu.datasets import get_dataset as jget_dataset  # noqa: E402
from audiossl_tpu.datasets import sed as jsed  # noqa: E402
from audiossl_tpu_torch.datasets import get_dataset  # noqa: E402
from audiossl_tpu_torch.datasets import sed  # noqa: E402

AS_LABELS = [f"/m/{i:04x}" for i in range(407)]


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """A DCASE tree (2 s clips) and an AudioSet-strong one (1 s clips)."""
    root = tmp_path_factory.mktemp("sed")
    dcase, as_strong = str(root / "dcase"), str(root / "as_strong")
    sed.write_synthetic_sed(
        dcase, {"synth_train": 7, "weak_train": 11, "synth_val": 5,
                "strong_val": 4}, sed.DCASE_CLASSES,
        weak_splits=("weak_train",), duration_splits=("strong_val",),
        seed=1, seconds=2.0)
    sed.write_synthetic_sed(
        as_strong, {"train": 6, "val": 3, "eval": 3}, AS_LABELS,
        duration_splits=("eval",), seed=2, seconds=1.0)
    return dcase, as_strong


@pytest.mark.parametrize("n", [7, 10, 25, 45])
def test_weak_split_matches_pandas(tmp_path, n):
    os.makedirs(tmp_path / "weak_train")
    rows = [(f"w{i}.wav", sed.DCASE_CLASSES[i % 10]) for i in range(n)]
    pd.DataFrame(rows, columns=["filename", "event_labels"]).to_csv(
        tmp_path / "weak_train" / "meta.tsv", sep="\t", index=False)
    train, val = sed._weak_train_val_split(str(tmp_path), 0.9, 42)
    jtrain, jval = jsed._weak_train_val_split(str(tmp_path), 0.9, 42)
    assert [r["filename"] for r in train] == list(jtrain.filename)
    assert [r["filename"] for r in val] == list(jval.filename)
    assert len(train) == round(0.9 * n) and len(train) + len(val) == n


def _assert_batches_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in ("wav", "valid", "strong", "source"):
            assert g[k].dtype == w[k].dtype, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
        assert g["filenames"] == w["filenames"]


@pytest.mark.parametrize("mode", [0, 1])
def test_mixed_batch_loader_matches_jax(trees, mode):
    dcase, _ = trees
    port = get_dataset("dcase").creator(dcase, split="train")
    ref = jget_dataset("dcase").creator(dcase, split="train")
    loaders = [cls(list(sets), [3, 2], seed=5, mode=mode)
               for cls, sets in ((sed.MixedBatchLoader, port),
                                 (jsed.MixedBatchLoader, ref))]
    assert len(loaders[0]) == len(loaders[1]) == (7 // 3 if mode == 0
                                                  else 10 // 2)
    firsts = []
    for epoch in (0, 1):
        for loader in loaders:
            loader.set_epoch(epoch)
        got, want = list(loaders[0]), list(loaders[1])
        _assert_batches_equal(got, want)
        assert set(got[0]["source"]) == {0, 1}
        assert got[0]["strong"].sum() > 0
        firsts.append(got[0]["filenames"])
    assert firsts[0] != firsts[1]  # each epoch shuffles anew
    # evaluation: no shuffle, the shorter last batch cycled
    for split in ("valid", "test"):
        p = get_dataset("dcase").creator(dcase, split=split)
        j = jget_dataset("dcase").creator(dcase, split=split)
        p, j = (p[0], j[0]) if split == "valid" else (p, j)
        _assert_batches_equal(
            list(sed.MixedBatchLoader([p], [3], shuffle=False)),
            list(jsed.MixedBatchLoader([j], [3], shuffle=False)))


def _assert_items_equal(port, ref):
    assert len(port) == len(ref) > 0
    for i in range(len(ref)):
        for g, w in zip(port[i], ref[i]):
            if isinstance(w, str):
                assert g == w
            else:
                np.testing.assert_array_equal(g, w)


def test_create_dcase_matches_jax(trees):
    dcase, _ = trees
    info, jinfo = get_dataset("dcase"), jget_dataset("dcase")
    assert (info.multi_label, info.num_labels) == (True, 10) == (
        jinfo.multi_label, jinfo.num_labels)
    for split in ("train", "valid"):
        for p, j in zip(info.creator(dcase, split=split),
                        jinfo.creator(dcase, split=split)):
            _assert_items_equal(p, j)
    test = info.creator(dcase, split="test")
    _assert_items_equal(test, jinfo.creator(dcase, split="test"))
    # a strong clip with several events, one with an event to the end
    assert max(len(e["events"]) for e in test.examples) > 1
    enc = sed.dcase_encoder()
    assert enc.n_frames == 250 and test[0][1].shape == (250, 10)


def test_create_as_strong_matches_jax(trees):
    _, as_strong = trees
    info, jinfo = get_dataset("as_strong"), jget_dataset("as_strong")
    assert info.num_labels == jinfo.num_labels == 407
    assert sed.load_as_strong_labels(
        os.path.join(as_strong, "common_labels.txt")) == AS_LABELS
    for split in ("train", "valid", "test"):
        p = info.creator(as_strong, split=split)
        _assert_items_equal(p, jinfo.creator(as_strong, split=split))
        assert p[0][0].shape == (160000,) and p[0][1].shape == (250, 407)


def test_unlabeled_set_matches_jax(trees):
    dcase, _ = trees
    folder = os.path.join(dcase, "synth_val", "audio")
    _assert_items_equal(sed.load_dcase_split(folder, None, "unlabeled"),
                        jsed.load_dcase_split(folder, None, "unlabeled"))
