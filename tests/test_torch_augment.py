"""The port's augmentations and token masks against the JAX package's
(``audiossl_tpu/transforms/augment.py``, ``ops/masking.py``) on the CPU.

The JAX functions draw from their keys; the same numbers, rebuilt from
those keys, go into the port's apply functions, which must reproduce the
JAX results (tolerance 1e-5; masks and crops exactly). The port's own
draws (a ``torch.Generator``) must give the distribution of JAX's: the
masked fraction and the mean run length of the masks, the ranges of the
mixup weights and partner shifts.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from audiossl_tpu.ops import masking as jmk  # noqa: E402
from audiossl_tpu.transforms import augment as jau  # noqa: E402
from audiossl_tpu_torch.ops import masking as tmk  # noqa: E402
from audiossl_tpu_torch.transforms import augment as tau  # noqa: E402

B = 6


def _t(a):
    return torch.from_numpy(np.array(a))  # a writable copy


def test_wav_to_f32_matches_jax():
    w = np.random.RandomState(0).randint(-32768, 32767, (3, 100)).astype(
        np.int16)
    np.testing.assert_array_equal(tau.wav_to_f32(_t(w)).numpy(),
                                  np.asarray(jau.wav_to_f32(jnp.asarray(w))))


@pytest.mark.parametrize("width", [3000, 2000])
def test_random_crop_wav_matches_jax(width):
    """A buffer wider than the crop (random starts, one clip shorter than
    the crop) and one as wide as the crop (start 0, no draw)."""
    rng = np.random.RandomState(1)
    valid = np.asarray([width, width - 500, 1000, width - 1, 2000, 1500],
                       np.int32)
    wav = rng.randn(B, width).astype(np.float32)
    crop_len = np.full((B,), 2000, np.int32)
    key = jax.random.PRNGKey(2)
    want, wvalid = jau.random_crop_wav(key, jnp.asarray(wav),
                                       jnp.asarray(valid),
                                       jnp.asarray(crop_len), 2000)
    got, gvalid = tau.random_crop_wav(
        _t(wav), _t(valid).long(), _t(crop_len).long(), 2000,
        _t(jax.random.uniform(key, (B,))))
    np.testing.assert_array_equal(gvalid.numpy(), np.asarray(wvalid))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_mixup_log_matches_jax():
    rng = np.random.RandomState(3)
    spec = rng.uniform(-1, 1, (B, 8, 30)).astype(np.float32)
    frames = np.asarray([30, 20, 7, 30, 1, 29], np.int32)
    key = jax.random.PRNGKey(4)
    want = jau.mixup_log(key, jnp.asarray(spec), 0.4,
                         valid_frames=jnp.asarray(frames))
    k1, k2 = jax.random.split(key)
    a = np.float32(0.4) * np.asarray(jax.random.uniform(k1, (B, 1, 1)))
    shift = jax.random.randint(k2, (B,), 1, B)
    got = tau.mixup_log(_t(spec), _t(a[:, 0, 0]), _t(shift).long(),
                        valid_frames=_t(frames).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_random_resize_crop_freq_warp_matches_jax():
    rng = np.random.RandomState(5)
    spec = rng.randn(B, 64, 30).astype(np.float32)
    frames = np.asarray([30, 20, 7, 30, 1, 29], np.int32)
    key = jax.random.PRNGKey(6)
    want = jau.random_resize_crop(
        key, jnp.asarray(spec), virtual_crop_scale=(1.0, 1.0),
        freq_scale=(0.6, 1.5), time_scale=(1.0, 1.0),
        valid_frames=jnp.asarray(frames))
    k1, _, k3, _ = jax.random.split(key, 4)
    got = tau.random_resize_crop(
        _t(spec), _t(jax.random.uniform(k1, (B,))),
        _t(jax.random.uniform(k3, (B,))), valid_frames=_t(frames).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("mask_type", ["block", "random", "uniform"])
def test_token_mask_matches_jax(mask_type):
    T, ratio, span = 250, 0.65, 5
    valid = np.asarray([250, 249, 120, 12, 3, 250], np.int32)
    key = jax.random.PRNGKey(7)
    want = jmk.make_token_mask(key, B, T, ratio, mask_type=mask_type,
                               span=span, min_span=2, valid=jnp.asarray(valid))
    if mask_type == "random":
        draws = {"u": _t(jax.random.uniform(key, (B, T)))}
    elif mask_type == "block":
        k_round, k_starts = jax.random.split(key)
        draws = {"u_round": _t(jax.random.uniform(k_round, (B,))),
                 "u_starts": _t(jax.random.uniform(k_starts, (B, T)))}
    else:
        k_round, k_len, k_starts = jax.random.split(key, 3)
        K = max(2, int(ratio * T / span) + 1)
        draws = {"u_round": _t(jax.random.uniform(k_round, (B,))),
                 "lengths": _t(jax.random.randint(k_len, (B, K), 2,
                                                  2 * span + 1)).long(),
                 "u_starts": _t(jax.random.uniform(k_starts, (B, T)))}
    got = tmk.make_token_mask(draws, ratio, mask_type, span, 2,
                              valid=_t(valid).long())
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _runs(mask):
    """Mean length of the runs of True along the last axis."""
    m = np.asarray(mask, np.int8)
    starts = np.sum(np.diff(np.pad(m, ((0, 0), (1, 0))), axis=1) == 1)
    return m.sum() / max(starts, 1)


def test_port_draws_give_the_mask_statistics_of_jax():
    """Block masks at the training step's shape (250 tokens, ratio 0.65,
    span 5) over 512 samples: the port's own draws and JAX's give the same
    masked fraction and run length within sampling noise."""
    n, T = 512, 250
    valid = np.full((n,), T, np.int32)
    want = np.asarray(jmk.block_token_mask(jax.random.PRNGKey(8), n, T, 0.65,
                                           span=5, valid=jnp.asarray(valid)))
    gen = torch.Generator().manual_seed(8)
    draws = tmk.draw_token_mask(gen, n, T, 0.65, "block", 5)
    got = tmk.make_token_mask(draws, 0.65, "block", 5,
                              valid=_t(valid).long()).numpy()
    assert abs(got.mean() - want.mean()) < 0.01, (got.mean(), want.mean())
    assert abs(_runs(got) / _runs(want) - 1.0) < 0.05
    # every sample masks at least the two fairseq minimum spans
    assert got.sum(axis=1).min() >= 5


def test_port_mixup_and_warp_draws_are_in_range():
    gen = torch.Generator().manual_seed(9)
    a, shift = tau.draw_mixup(gen, 1000, 0.4, "cpu")
    assert 0.0 <= float(a.min()) and float(a.max()) < 0.4
    assert int(shift.min()) == 1 and int(shift.max()) == 999
    h_u, iy_u = tau.draw_resize_crop(gen, 1000, "cpu")
    for u in (h_u, iy_u, tau.draw_crop(gen, 1000, "cpu")):
        assert 0.0 <= float(u.min()) and float(u.max()) < 1.0


def _mask_draws(key, width):
    """The (widths, start uniforms) JAX's one-mask ``freq_mask`` /
    ``time_mask`` draws from ``key``."""
    k1, k2 = jax.random.split(jax.random.split(key, 1)[0])
    return (_t(jax.random.randint(k1, (B, 1), 0, width))[:, 0].long(),
            _t(jax.random.uniform(k2, (B, 1)))[:, 0])


@pytest.mark.parametrize("valid", [False, True])
def test_spec_masks_match_jax(valid):
    """The finetuning step's SpecAugment masks (band 10 in frequency, 50 in
    time, the time mask within each sample's valid frames), exactly."""
    spec = np.random.RandomState(20).randn(B, 64, 120).astype(np.float32)
    frames = np.asarray([120, 97, 51, 30, 10, 1], np.int32)
    kf, kt = jax.random.split(jax.random.PRNGKey(21))
    vf = jnp.asarray(frames) if valid else None
    want = jau.time_mask(kt, jau.freq_mask(kf, jnp.asarray(spec), 10), 50,
                         valid_frames=vf)
    got = tau.time_mask(tau.freq_mask(_t(spec), *_mask_draws(kf, 10)),
                        *_mask_draws(kt, 50),
                        valid_frames=_t(frames).long() if valid else None)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int((got.numpy() == 0).sum()) > 0


def test_port_mask_draws_cover_their_ranges():
    gen = torch.Generator().manual_seed(22)
    width, u = tau.draw_mask(gen, 2000, 50, "cpu")
    assert int(width.min()) == 0 and int(width.max()) == 49
    assert 0.0 <= float(u.min()) and float(u.max()) < 1.0
    assert abs(float(width.float().mean()) - 24.5) < 1.5
