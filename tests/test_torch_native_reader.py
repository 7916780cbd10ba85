"""The port's packed dataset and native .ards reader against the JAX
package's on the same packs (CPU; the reader is built with g++).

Exact comparisons throughout (tolerance 0): the dataset's keys and items
with and without ``subset`` and ``seed``; ``dtype_code`` and
``all_int16``; the native reader's batches (float32
and int16) against JAX's native reader and against the port's Python
``BatchLoader``, bit for bit.
"""
import numpy as np
import pytest

from audiossl_tpu.datasets import native as jnative
from audiossl_tpu.datasets import packed as jpacked
from audiossl_tpu_torch.datasets import native as tnative
from audiossl_tpu_torch.datasets import packed as tpacked
from audiossl_tpu_torch.datasets.pipeline import BatchLoader

N = 11


@pytest.fixture(scope="module")
def pack(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("pack"))
    tpacked.write_synthetic_pack(path, "train", N, min_s=0.2, max_s=0.9,
                                 seed=3)
    return path


@pytest.fixture(scope="module")
def mixed_pack(tmp_path_factory):
    """Int16 records with one float32 stereo record among them."""
    path = str(tmp_path_factory.mktemp("mixed"))
    rng = np.random.RandomState(4)
    with tpacked.PackedWriter(f"{path}/train.ards") as w:
        for i in range(6):
            if i == 3:
                w.add((rng.randn(2, 5000) * 0.3).astype(np.float32), i)
            else:
                w.add((rng.randn(4000 + 700 * i) * 3000).astype(np.int16), i)
    return path


@pytest.mark.parametrize("subset", [None, 4, 5, 11, 30])
def test_dataset_keys_match_jax(pack, subset):
    for kw in (dict(), dict(seed=9)):
        j = jpacked.PackedAudioDataset(pack, "train", subset=subset, **kw)
        t = tpacked.PackedAudioDataset(pack, "train", subset=subset, **kw)
        assert len(t) == len(j) == min(subset or N, N)
        np.testing.assert_array_equal(t.keys, j.keys)


def test_dataset_items_match_jax(pack):
    j = jpacked.PackedAudioDataset(pack, "train", subset=5, seed=9)
    t = tpacked.PackedAudioDataset(pack, "train", subset=5, seed=9)
    for i in range(len(t)):
        (tw, ty), (jw, jy) = t[i], j[i]
        assert ty == jy
        np.testing.assert_array_equal(tw, jw)


def test_dtype_code_and_all_int16_match_jax(pack, mixed_pack):
    for path, want in ((pack, True), (mixed_pack, False)):
        t = tpacked.PackedReader(f"{path}/train.ards")
        j = jpacked.PackedReader(f"{path}/train.ards")
        assert [t.dtype_code(i) for i in range(len(t))] == [
            j.dtype_code(i) for i in range(len(j))]
        assert t.all_int16() == j.all_int16() == want
    # probing fewer headers than records can miss the float32 one, in both
    t = tpacked.PackedReader(f"{mixed_pack}/train.ards")
    j = jpacked.PackedReader(f"{mixed_pack}/train.ards")
    assert t.all_int16(probe=2) == j.all_int16(probe=2)


@pytest.mark.parametrize("wav_dtype", [np.float32, np.int16])
def test_native_reader_matches_jax_native_reader(mixed_pack, wav_dtype):
    path = f"{mixed_pack}/train.ards"
    t, j = tnative.NativeReader(path), jnative.NativeReader(path)
    assert len(t) == len(j) == 6
    assert [t.num_samples(i) for i in range(6)] == [
        j.num_samples(i) for i in range(6)]
    idx = np.asarray([5, 3, 0, 3, 1])
    for pad in (3000, 9000):
        tw, tv = t.read_batch(idx, pad, n_threads=3, dtype=wav_dtype)
        jw, jv = j.read_batch(idx, pad, n_threads=3, dtype=wav_dtype)
        assert tw.dtype == jw.dtype == wav_dtype
        np.testing.assert_array_equal(tw, jw)
        np.testing.assert_array_equal(tv, jv)


@pytest.mark.parametrize("wav_dtype", [np.float32, np.int16])
def test_native_batches_match_jax_and_the_python_loader(pack, wav_dtype):
    """Two epochs of the port's NativeBatchLoader against JAX's and
    against the port's BatchLoader without labels."""
    t_ds = tpacked.PackedAudioDataset(pack, "train", subset=9)
    j_ds = jpacked.PackedAudioDataset(pack, "train", subset=9)
    kw = dict(batch_size=2, pad_samples=8000, seed=5, wav_dtype=wav_dtype)
    for epoch in (0, 1):
        got = list(tnative.NativeBatchLoader(t_ds, epoch=epoch,
                                             n_threads=2, **kw))
        want = list(jnative.NativeBatchLoader(j_ds, epoch=epoch, **kw))
        python = list(BatchLoader(t_ds, epoch=epoch, include_labels=False,
                                  num_threads=3, **kw))
        assert len(got) == len(want) == len(python) == 4
        for g, w, p in zip(got, want, python):
            assert g.keys() == w.keys() == p.keys() == {"wav", "valid"}
            for k in g:
                assert g[k].dtype == w[k].dtype == p[k].dtype
                np.testing.assert_array_equal(g[k], w[k])
                np.testing.assert_array_equal(g[k], p[k])


def test_native_reader_refuses_bad_input(pack):
    r = tnative.NativeReader(f"{pack}/train.ards")
    with pytest.raises(IOError):
        r.read_batch(np.asarray([N + 5]), 100)
    with pytest.raises(ValueError, match="float32 or int16"):
        r.read_batch(np.asarray([0]), 100, dtype=np.float64)
    with pytest.raises(IndexError):
        r.num_samples(N)
    with pytest.raises(IOError):
        tnative.NativeReader(f"{pack}/missing.ards")


def test_native_loader_stops_early_and_goes_on(pack):
    """Breaking out mid-epoch stops the worker; the next epoch reads all
    its batches."""
    ds = tpacked.PackedAudioDataset(pack, "train")
    loader = tnative.NativeBatchLoader(ds, 2, 4000, seed=1)
    for k, _ in enumerate(loader):
        if k == 1:
            break
    assert len(list(loader)) == len(loader) == N // 2


def test_reader_library_is_built_under_build_with_a_source_hash():
    path = tnative.build()
    assert path.parent == tnative.BUILD_DIR
    assert path.name.startswith("libards_reader_") and path.suffix == ".so"
    assert len(path.stem.rsplit("_", 1)[1]) == 16
