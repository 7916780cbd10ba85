"""Kernel K1's band table and band walk (``ops/mel_db.py``,
``csrc/mel_db.cu``) on the CPU.

The table must give each filterbank back bit for bit; a plain emulation of
the kernel's walk over it (pairs in table order, ascending bins within a
mel, one f32 FMA per pair into one accumulator per mel) must match the
plain version and the JAX package's Pallas kernel in interpret mode at a
ragged frame count, within 1e-4 dB (f32 sums in another order); and the
wrapper must take the plain version for CPU tensors, refuse meta tensors
before it reads the filterbank, and on the kernel path build the table
once per filterbank and launch with it.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from audiossl_tpu.ops.pallas_mel import stft_to_mel_db as j_stft_to_mel_db  # noqa: E402
from audiossl_tpu_torch.kernels import build as kb  # noqa: E402
from audiossl_tpu_torch.ops import mel_db as md  # noqa: E402
from audiossl_tpu_torch.ops.melspec import MelConfig, mel_filterbank  # noqa: E402

AMIN = 1e-10
DB_ATOL = 1e-4


def _fb(kind):
    """A filterbank [513, 64]: the recipe's HTK triangles, a dense random
    one, the recipe's with an all-zero mel column, with a zero inside a
    band, and one whose bands overlap by far more than 2."""
    fb = mel_filterbank(MelConfig(), torch.device("cpu")).numpy().copy()
    rng = np.random.RandomState(5)
    if kind == "dense":
        return rng.rand(513, 64).astype(np.float32)
    if kind == "zero_column":
        fb[:, 7] = 0.0
        fb[:, 63] = 0.0
    elif kind == "zero_inside":
        lo = np.flatnonzero(fb[:, 40])
        fb[lo[3], 40] = 0.0
        fb[lo[4], 40] = -0.0
    elif kind == "wide":
        fb = np.zeros((513, 64), np.float32)
        for m in range(64):
            fb[m: m + 200 + m, m] = rng.rand(200 + m)
    return fb


def _rebuild(words, F, n_mels, n_groups, n_pairs):
    fb = np.zeros((F, n_mels), np.float32)
    for m, bins, flags, w in md.table_groups(words, n_groups, n_pairs):
        for f, fl, x in zip(bins, flags, w):
            if not fl & md.EMPTY:
                fb[f, m] = x
            m += bool(fl & md.LAST)
    return fb


def _walk(stft, words, n_mels, n_groups, n_pairs, amin=AMIN):
    """Plain emulation of the kernel: per group and frame, the pairs in
    table order, the power rounded as re*re + im*im in f32, one FMA (exact
    product, one rounding of the sum) per pair, the dB where a band ends."""
    B, F2, T = stft.shape
    F = F2 // 2
    re, im = stft[:, :F], stft[:, F:]
    out = np.full((B, n_mels, T), np.nan, np.float32)
    scale = np.float32(md._LOG10_SCALE)
    for m, bins, flags, w in md.table_groups(words, n_groups, n_pairs):
        acc = np.zeros((B, T), np.float32)
        for f, fl, x in zip(bins, flags, w):
            if not fl & md.EMPTY:
                p = re[:, f] * re[:, f] + im[:, f] * im[:, f]
                acc = (acc.astype(np.float64)
                       + np.float64(x) * p.astype(np.float64)).astype(
                           np.float32)
            if fl & md.LAST:
                out[:, m] = scale * np.log(np.maximum(acc, np.float32(amin)))
                acc = np.zeros((B, T), np.float32)
                m += 1
    return out


def _stft(B=2, F=513, T=97, seed=0):
    """A numpy-seeded STFT [B, 2F, T] with the spread of a real one, and one
    silent frame (every mel at amin)."""
    rng = np.random.RandomState(seed)
    x = rng.randn(B, 2 * F, T).astype(np.float32)
    x *= np.exp(rng.randn(B, 1, T) * 2.0).astype(np.float32)
    x[1, :, 5] = 0.0
    return x


KINDS = ["recipe", "dense", "zero_column", "zero_inside", "wide"]


@pytest.mark.parametrize("kind", KINDS)
def test_band_table_rebuilds_the_filterbank_bit_for_bit(kind):
    fb = _fb(kind)
    words, n_groups, n_pairs = md.band_table(fb)
    assert words.dtype == np.int32
    got = _rebuild(words, *fb.shape, n_groups, n_pairs)
    np.testing.assert_array_equal(got.view(np.uint32), fb.view(np.uint32))
    # groups of consecutive mels, each at most GROUP_PAIRS pairs or one band
    mels = [m for m, *_ in md.table_groups(words, n_groups, n_pairs)]
    assert mels[0] == 0 and all(np.diff(mels) > 0)
    for m, bins, flags, _ in md.table_groups(words, n_groups, n_pairs):
        n_bands = int((flags & md.LAST).astype(bool).sum())
        assert n_bands >= 1 and flags[-1] & md.LAST
        assert bins.size <= md.GROUP_PAIRS or n_bands == 1
        # ascending bins within each band
        ends = np.flatnonzero(flags & md.LAST)
        for band in np.split(bins, ends[:-1] + 1):
            assert np.all(np.diff(band) == 1)


def test_recipe_band_table_counts():
    """The recipe's filterbank: 970 pairs (its non-zeros, as each band has
    no zero inside) over bins 4-499, in groups of at most GROUP_PAIRS."""
    fb = _fb("recipe")
    words, n_groups, n_pairs = md.band_table(fb)
    assert n_pairs == int((fb != 0).sum()) == 970
    bins = np.concatenate([b for _, b, *_ in md.table_groups(words, n_groups,
                                                         n_pairs)])
    assert (bins.min(), bins.max()) == (4, 499)
    assert 970 / md.GROUP_PAIRS <= n_groups <= 2 * 970 / md.GROUP_PAIRS


@pytest.mark.parametrize("kind", KINDS)
def test_band_walk_matches_plain_and_pallas(kind):
    """The kernel's walk over the band table against the plain version and
    JAX's Pallas kernel (interpret mode) on the same numpy STFT, at a
    ragged shape [2, 1026, 97]."""
    fb = _fb(kind)
    stft = _stft()
    words, n_groups, n_pairs = md.band_table(fb)
    got = _walk(stft, words, fb.shape[1], n_groups, n_pairs)
    plain = md.stft_to_mel_db_ref(torch.from_numpy(stft),
                                  torch.from_numpy(fb), AMIN).numpy()
    want = np.asarray(j_stft_to_mel_db(jnp.asarray(stft), jnp.asarray(fb),
                                       amin=AMIN, interpret=True))
    assert got.shape == plain.shape == want.shape == (2, 64, 97)
    np.testing.assert_allclose(got, plain, atol=DB_ATOL, rtol=0)
    np.testing.assert_allclose(got, want, atol=DB_ATOL, rtol=0)
    np.testing.assert_allclose(got[1, :, 5], -100.0, atol=DB_ATOL, rtol=0)


def test_cpu_tensors_take_the_plain_version(monkeypatch):
    monkeypatch.setattr(md, "band_table", _refuse)
    kb.reset_launches()
    stft, fb = torch.from_numpy(_stft()), torch.from_numpy(_fb("recipe"))
    got = md.stft_to_mel_db(stft, fb, AMIN)
    torch.testing.assert_close(got, md.stft_to_mel_db_ref(stft, fb, AMIN),
                               rtol=0, atol=0)
    assert kb.LAUNCHES["mel_db"] == 0


def _refuse(*a, **k):
    raise AssertionError("the filterbank was read")


def test_meta_tensors_raise_before_the_filterbank_is_read(monkeypatch):
    monkeypatch.setattr(md, "band_table", _refuse)
    meta = torch.device("meta")
    with pytest.raises(ValueError, match="CUDA device"):
        md.stft_to_mel_db(torch.empty(2, 1026, 97, device=meta),
                          torch.empty(513, 64, device=meta))


def test_kernel_path_builds_the_table_once_and_launches_with_it(monkeypatch):
    """Off the CPU the wrapper builds the band table at its first call for
    a filterbank, reuses it until the filterbank changes in place, and
    launches once a call with it. A meta STFT reaches the kernel path;
    the device checks pass and the launch is captured."""
    launched, built = [], []
    monkeypatch.setattr(kb, "require_cuda", lambda *a: None)
    monkeypatch.setattr(kb, "ptr", lambda t: t)
    monkeypatch.setattr(kb, "launch",
                        lambda name, dev, *args: launched.append((name, args)))
    band_table = md.band_table
    monkeypatch.setattr(md, "band_table",
                        lambda fb: built.append(fb) or band_table(fb))
    monkeypatch.setattr(md, "_TABLES", type(md._TABLES)())
    stft = torch.empty(3, 1026, 1001, device=torch.device("meta"))
    fb = torch.from_numpy(_fb("recipe"))
    for _ in range(3):
        out = md.stft_to_mel_db(stft, fb, AMIN)
    assert out.shape == (3, 64, 1001) and len(built) == 1
    words, n_groups, n_pairs = band_table(fb.numpy())
    for name, args in launched:
        assert name == "mel_db" and args[0] is stft
        assert args[1] is launched[0][1][1]  # one table tensor, kept
        np.testing.assert_array_equal(args[1].numpy(), words)
        assert args[3:] == (3, 513, 1001, 64, n_groups, n_pairs, AMIN)
    fb.mul_(2.0)  # in place: a new version, so a new table
    md.stft_to_mel_db(stft, fb, AMIN)
    assert len(built) == 2
    np.testing.assert_array_equal(launched[-1][1][1].numpy(),
                                  band_table(fb.numpy())[0])
    with pytest.raises(ValueError, match="f32"):
        md.stft_to_mel_db(stft, fb.double(), AMIN)


def _capture_launches(monkeypatch):
    """Sends the wrapper's launches to a list (the device checks pass), so
    a meta STFT goes down the kernel path on the CPU."""
    launched = []
    monkeypatch.setattr(kb, "require_cuda", lambda *a: None)
    monkeypatch.setattr(kb, "ptr", lambda t: t)
    monkeypatch.setattr(kb, "launch",
                        lambda name, dev, *args: launched.append(args))
    monkeypatch.setattr(md, "_TABLES", type(md._TABLES)())
    return launched


def test_inference_mode_filterbank_takes_the_kernel_path(monkeypatch):
    """The serving entry points run under ``torch.inference_mode``, so in
    a fresh process ``mel_filterbank`` builds an inference tensor, which
    keeps no version counter: the wrapper still builds its band table once
    and launches with it, inside inference mode and out."""
    launched = _capture_launches(monkeypatch)
    mel_filterbank.cache_clear()
    try:
        stft = torch.empty(2, 1026, 97, device=torch.device("meta"))
        with torch.inference_mode():
            fb = mel_filterbank(MelConfig(), torch.device("cpu"))
            assert fb.is_inference()
            out = md.stft_to_mel_db(stft, fb, AMIN)
            md.stft_to_mel_db(stft, fb, AMIN)
        md.stft_to_mel_db(stft, fb, AMIN)
    finally:
        mel_filterbank.cache_clear()
    assert out.shape == (2, 64, 97) and len(launched) == 3
    assert len(md._TABLES) == 1
    words, n_groups, n_pairs = md.band_table(fb.numpy())
    for args in launched:
        assert args[1] is launched[0][1]
        np.testing.assert_array_equal(args[1].numpy(), words)
        assert args[3:] == (2, 513, 97, 64, n_groups, n_pairs, AMIN)
