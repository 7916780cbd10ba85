"""``datamodules.py`` and ``utils/plot.py`` against the JAX package's (CPU).

* ``DownstreamDataModule``: the train, valid and test loaders of one
  written ``audioset_b`` pack batch for batch equal to JAX's (the
  shuffled train order included), and ``audioset`` concatenating the
  balanced pack beside it; ``ConcatDataset`` and ``InMemoryDataModule``
  (shuffled and not) equal to JAX's;
* ``EmbeddingExtractor`` over the valid loader with the log-mel mean as
  the extractor (the mel kernel K1's plain version here): the embeddings
  within 1e-5 of JAX's, the labels equal;
* ``plot_attention``'s maps of a jittered frame-tiny encoder equal to
  JAX's within 1e-6; ``plot_spec`` and ``plot_attention(path=...)``
  write a PNG where matplotlib imports.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from audiossl_tpu import datamodules as jdm  # noqa: E402
from audiossl_tpu_torch import datamodules as dm  # noqa: E402
from audiossl_tpu_torch.datasets import write_synthetic_pack  # noqa: E402

SPLITS = (("train", 10), ("valid", 7), ("test", 5))


@pytest.fixture(scope="module")
def packs(tmp_path_factory):
    root = tmp_path_factory.mktemp("packs")
    for name in ("audioset", "audioset_b"):
        for i, (split, n) in enumerate(SPLITS):
            write_synthetic_pack(str(root / name), split, n, min_s=0.3,
                                 max_s=1.2, num_labels=527,
                                 multi_label=True, seed=i + 3 * len(name))
    return root


def _modules(packs, name):
    kw = dict(batch_size=3, train_len_s=1.0,
              loader_kwargs=dict(num_threads=1))
    return (dm.DownstreamDataModule(str(packs / name), name, **kw),
            jdm.DownstreamDataModule(str(packs / name), name, **kw))


def _batches(loader):
    return [{k: np.asarray(v) for k, v in b.items()} for b in loader]


@pytest.mark.parametrize("name", ["audioset_b", "audioset"])
def test_downstream_data_module_matches_jax(packs, name):
    mod, jmod = _modules(packs, name)
    assert (mod.num_labels, mod.multi_label) == (jmod.num_labels,
                                                 jmod.multi_label)
    for split in ("train", "val", "test"):
        got = _batches(getattr(mod, f"{split}_dataloader")())
        want = _batches(getattr(jmod, f"{split}_dataloader")())
        assert len(got) == len(want) > 0, split
        for g, w in zip(got, want):
            assert set(g) == set(w)
            for k in w:
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    if name == "audioset":  # the balanced pack's 10 train clips joined
        assert len(mod.train_dataloader().dataset) == 20


def test_concat_and_in_memory_match_jax():
    parts = [list(range(3)), list(range(10, 12)), [], list(range(20, 24))]
    cat, jcat = dm.ConcatDataset(parts), jdm.ConcatDataset(parts)
    assert len(cat) == len(jcat) == 9
    assert [cat[i] for i in range(9)] == [jcat[i] for i in range(9)]
    with pytest.raises(IndexError):
        cat[9]
    rng = np.random.RandomState(2)
    arrays = [rng.randn(11, 4), rng.randint(0, 3, 11), rng.randn(5, 4),
              rng.randint(0, 3, 5), rng.randn(6, 4), rng.randint(0, 3, 6)]
    mem = dm.InMemoryDataModule(*arrays, batch_size=4)
    jmem = jdm.InMemoryDataModule(*arrays, batch_size=4)
    for split in ("train", "valid", "test"):
        for shuffle in (False, True):
            got = list(mem.iter_split(split, shuffle, seed=7))
            want = list(jmem.iter_split(split, shuffle, seed=7))
            assert len(got) == len(want)
            for (x, y), (jx, jy) in zip(got, want):
                np.testing.assert_array_equal(x, jx)
                np.testing.assert_array_equal(y, jy)


def test_embedding_extractor_matches_jax(packs):
    from audiossl_tpu.ops.melspec import log_melspec as jmel
    from audiossl_tpu_torch.ops.melspec import log_melspec

    mod, jmod = _modules(packs, "audioset_b")

    def extract(wav, valid):
        return log_melspec(torch.as_tensor(wav),
                           torch.as_tensor(valid)).mean(-1)

    def jextract(wav, valid):
        return jmel(jnp.asarray(wav), jnp.asarray(valid)).mean(-1)

    x, y = dm.EmbeddingExtractor(extract).extract(mod.val_dataloader())
    jx, jy = jdm.EmbeddingExtractor(jextract).extract(jmod.val_dataloader())
    assert x.shape == jx.shape == (7, 64)
    np.testing.assert_array_equal(y, jy)
    np.testing.assert_allclose(x, jx, atol=1e-5)


@pytest.fixture(scope="module")
def encoders():
    from audiossl_tpu.models.atst import frame_ast_tiny as jtiny
    from audiossl_tpu_torch.compat.checkpoint import state_dict_from_flax
    from audiossl_tpu_torch.models.atst import frame_ast_tiny

    rng = np.random.RandomState(4)
    jenc = jtiny(spec_w=101)
    params = jenc.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 101)),
                       length=jnp.asarray([101]), deterministic=True)["params"]
    params = jax.tree.map(lambda a: np.asarray(a) + (0.05 * rng.randn(
        *a.shape)).astype(np.float32), params)
    enc = frame_ast_tiny(spec_w=101, device="cpu")
    enc.load_state_dict(state_dict_from_flax(params))
    mel = rng.randn(2, 64, 101).astype(np.float32)
    return jenc, params, enc.eval(), mel


def test_plot_attention_maps_match_jax(encoders):
    from audiossl_tpu.utils.plot import plot_attention as jplot
    from audiossl_tpu_torch.utils.plot import plot_attention

    jenc, params, enc, mel = encoders
    length = np.asarray([101, 60])
    want = jplot(jenc, params, jnp.asarray(mel), jnp.asarray(length))
    got = plot_attention(enc, torch.from_numpy(mel),
                         torch.from_numpy(length))
    assert isinstance(got, np.ndarray) and got.shape == want.shape
    assert got.shape == (2, 2, 25, 25)
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_plots_write_png(encoders, tmp_path):
    pytest.importorskip("matplotlib")
    from audiossl_tpu_torch.utils.plot import plot_attention, plot_spec

    _, _, enc, mel = encoders
    spec_png, attn_png = tmp_path / "spec.png", tmp_path / "attn.png"
    plot_spec(torch.from_numpy(mel[0]), str(spec_png), title="mel")
    maps = plot_attention(enc, torch.from_numpy(mel), path=str(attn_png))
    assert maps.shape == (2, 2, 25, 25)
    for png in (spec_png, attn_png):
        assert png.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
