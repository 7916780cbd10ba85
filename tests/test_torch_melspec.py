"""PyTorch port's mel front end against the JAX package (CPU, f32).

The port's ``log_melspec`` always runs the mel kernel's branch (framed
STFT -> ``stft_to_mel_db`` -> boundary patch -> top-dB/MinMax); on a
CPU tensor the kernel wrapper takes its plain version. The JAX
``log_melspec`` on CPU takes its non-Pallas branch, which computes the
same values. Tolerance 1e-4 on the normalized mel (f32 sums taken in
another order by the two frameworks).
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from audiossl_tpu.ops import melspec as jmel  # noqa: E402
from audiossl_tpu.ops.pallas_mel import stft_to_mel_db as j_stft_to_mel_db  # noqa: E402
from audiossl_tpu_torch.ops import melspec as tmel  # noqa: E402
from audiossl_tpu_torch.ops.mel_db import stft_to_mel_db_ref  # noqa: E402


def _wav(B, L, seed=0):
    return (np.random.RandomState(seed).randn(B, L) * 0.1).astype(np.float32)


@pytest.mark.parametrize("lengths", [None, (24000, 17123, 9999)])
def test_log_melspec_matches_jax(lengths):
    wav = _wav(3, 24000)
    if lengths is not None:  # zero-pad past each sample's valid count
        for i, n in enumerate(lengths):
            wav[i, n:] = 0.0
    jl = None if lengths is None else jnp.asarray(lengths, jnp.int32)
    want = np.asarray(jmel.log_melspec(jnp.asarray(wav), jl,
                                       use_pallas=False))
    tl = None if lengths is None else torch.tensor(lengths)
    got = tmel.log_melspec(torch.from_numpy(wav), tl).numpy()
    assert got.shape == want.shape == (3, 64, 151)
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_stft_conv_matches_jax():
    wav = _wav(2, 16123, seed=1)
    want = np.asarray(jmel.stft_conv(jnp.asarray(wav)))
    got = tmel.stft_conv(torch.from_numpy(wav)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-4)


def test_boundary_power_fix_matches_jax():
    wav = _wav(3, 24000, seed=2)
    lengths = np.asarray([24000, 17123, 12000], np.int32)
    jfix, jt0 = jmel._boundary_power_fix(jnp.asarray(wav),
                                         jnp.asarray(lengths), jmel.MelConfig())
    fix, t0 = tmel._boundary_power_fix(torch.from_numpy(wav),
                                       torch.from_numpy(lengths),
                                       tmel.MelConfig())
    np.testing.assert_array_equal(t0.numpy(), np.asarray(jt0))
    np.testing.assert_allclose(fix.numpy(), np.asarray(jfix), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("lengths", [None, (24000, 17123, 12000)])
def test_power_spectrogram_matches_jax(lengths):
    wav = _wav(3, 24000, seed=4)
    jl = None if lengths is None else jnp.asarray(lengths, jnp.int32)
    want = np.asarray(jmel.power_spectrogram(jnp.asarray(wav), jl))
    tl = None if lengths is None else torch.tensor(lengths)
    got = tmel.power_spectrogram(torch.from_numpy(wav), tl).numpy()
    assert got.shape == want.shape == (3, 151, 513)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_stft_to_mel_db_ref_matches_pallas_interpret():
    """Plain version of kernel K1 against the Pallas kernel (interpret
    mode) on a ragged frame count (T = 101, not a multiple of 256)."""
    cfg = jmel.MelConfig()
    stft = jmel.stft_conv(jnp.asarray(_wav(2, 16000, seed=3)), cfg)
    fb = jmel.mel_filterbank(cfg)
    want = np.asarray(j_stft_to_mel_db(stft, fb, amin=cfg.amin,
                                       interpret=True))
    got = stft_to_mel_db_ref(torch.tensor(np.asarray(stft)),
                             torch.tensor(np.asarray(fb)),
                             amin=cfg.amin).numpy()
    assert got.shape == want.shape == (2, 64, 101)
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_filterbank_and_dft_filters_match_jax():
    cfg = tmel.MelConfig()
    np.testing.assert_array_equal(
        tmel.mel_filterbank(cfg, torch.device("cpu")).numpy(),
        np.asarray(jmel.mel_filterbank(jmel.MelConfig())))
    np.testing.assert_array_equal(tmel._dft_filters_np(1024, 1024),
                                  jmel._dft_filters_np(1024, 1024))


def test_training_stft_precision_matches_jax():
    """The training mel (``stft_precision="default"``; the JAX package's
    hop-decomposed framed product, the port's TF32 product on a card) is
    the f32 mel on the CPU in both; an unknown precision raises."""
    wav = _wav(2, 16000, seed=3)
    lengths = (16000, 12345)
    wav[1, lengths[1]:] = 0.0
    want = np.asarray(jmel.log_melspec(
        jnp.asarray(wav), jnp.asarray(lengths, jnp.int32),
        jmel.MelConfig(stft_precision="default"), use_pallas=False))
    got = tmel.log_melspec(torch.from_numpy(wav), torch.tensor(lengths),
                           tmel.MelConfig(stft_precision="default")).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4)
    with pytest.raises(ValueError, match="stft_precision"):
        tmel.stft_conv(torch.from_numpy(wav),
                       tmel.MelConfig(stft_precision="bf16"))
