"""Log-mel spectrogram front end on the device (PyTorch port).

Counterpart of ``audiossl_tpu/ops/melspec.py``: torchaudio
``MelSpectrogram`` + ``AmplitudeToDB(stype="power", top_db=80)`` +
``MinMax(-79.6482, 50.6842)`` applied per exact-length crop, computed
batched on zero-padded waveforms with per-sample valid sample counts.

The pipeline is the one the TPU package runs on its chip:

1. framed f32 STFT as one matrix product with Hann-windowed DFT filters
   over a statically reflect-padded buffer (:func:`stft_conv`);
2. ``|STFT|^2 -> mel filterbank -> dB`` in the mel kernel
   (:func:`audiossl_tpu_torch.ops.mel_db.stft_to_mel_db`);
3. the few frames whose window crosses a sample's own valid-length
   boundary are recomputed exactly (:func:`_boundary_power_fix`) and
   patched in;
4. the per-sample top-dB clamp over valid frames and MinMax
   (:func:`_topdb_minmax`).

``MelConfig.stft_precision`` chooses the STFT product's precision, as in
the JAX package (``ops/melspec.py:59-62``): ``"high"`` (serving) runs it in
full f32 with TF32 switched off; ``"default"`` (the training mel) lets
cuBLAS round its f32 operands to TF32 on the card, one tensor-core pass
(10-bit mantissa; the JAX package's 1-pass bf16 documents ~2e-3 error).
On the CPU both are full f32.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Optional

import numpy as np
import torch

from audiossl_tpu_torch.ops.mel_db import stft_to_mel_db, stft_to_mel_db_ref

# MinMax constants of the reference recipe (AudioSet train mel statistics).
MEL_MIN = -79.6482
MEL_MAX = 50.6842


@dataclasses.dataclass(frozen=True)
class MelConfig:
    sample_rate: int = 16000
    n_fft: int = 1024
    win_length: int = 1024
    hop_length: int = 160
    n_mels: int = 64
    f_min: float = 60.0
    f_max: float = 7800.0
    top_db: float = 80.0
    amin: float = 1e-10
    mel_min: float = MEL_MIN
    mel_max: float = MEL_MAX
    # "high"/"highest": full f32 STFT product; "default": TF32 on the card
    stft_precision: str = "high"

    @property
    def n_freqs(self) -> int:
        return self.n_fft // 2 + 1

    def num_frames(self, num_samples: int) -> int:
        # torch.stft with center=True: 1 + L // hop
        return 1 + num_samples // self.hop_length


def hann_window(win_length: int, device=None) -> torch.Tensor:
    """Periodic Hann window (torch.hann_window(periodic=True))."""
    n = torch.arange(win_length, dtype=torch.float32, device=device)
    return 0.5 * (1.0 - torch.cos(2.0 * np.pi * n / win_length))


def _hz_to_mel_htk(f):
    return 2595.0 * np.log10(1.0 + np.asarray(f, dtype=np.float64) / 700.0)


def _mel_to_hz_htk(m):
    return 700.0 * (10.0 ** (np.asarray(m, dtype=np.float64) / 2595.0) - 1.0)


@functools.lru_cache(maxsize=8)
def _mel_filterbank_np(
    n_freqs: int, f_min: float, f_max: float, n_mels: int, sample_rate: int
) -> np.ndarray:
    """HTK-scale triangular mel filterbank, shape [n_freqs, n_mels]
    (torchaudio ``melscale_fbanks`` defaults: ``mel_scale="htk"``,
    ``norm=None``)."""
    all_freqs = np.linspace(0.0, sample_rate / 2.0, n_freqs)
    m_pts = np.linspace(_hz_to_mel_htk(f_min), _hz_to_mel_htk(f_max),
                        n_mels + 2)
    f_pts = _mel_to_hz_htk(m_pts)  # [n_mels + 2]
    f_diff = f_pts[1:] - f_pts[:-1]  # [n_mels + 1]
    slopes = f_pts[None, :] - all_freqs[:, None]  # [n_freqs, n_mels + 2]
    down = -slopes[:, :-2] / f_diff[:-1]
    up = slopes[:, 2:] / f_diff[1:]
    fb = np.maximum(0.0, np.minimum(down, up))
    return fb.astype(np.float32)


@functools.lru_cache(maxsize=8)
def mel_filterbank(cfg: MelConfig, device) -> torch.Tensor:
    """[n_freqs, n_mels] f32 filterbank on ``device`` (cached)."""
    return torch.from_numpy(_mel_filterbank_np(
        cfg.n_freqs, cfg.f_min, cfg.f_max, cfg.n_mels, cfg.sample_rate
    )).to(device)


@functools.lru_cache(maxsize=4)
def _dft_filters_np(n_fft: int, win_length: int) -> np.ndarray:
    """Hann-windowed real-DFT analysis filters [2*n_freqs, win_length]:
    rows 0..F-1 = cos (real part), rows F..2F-1 = -sin (imag part)."""
    n = np.arange(win_length)[None, :]
    k = np.arange(n_fft // 2 + 1)[:, None]
    ang = 2.0 * np.pi * k * n / n_fft
    hann = 0.5 * (1.0 - np.cos(2.0 * np.pi * np.arange(win_length)
                               / win_length))
    cos = np.cos(ang) * hann[None, :]
    sin = -np.sin(ang) * hann[None, :]
    return np.concatenate([cos, sin], 0).astype(np.float32)


@functools.lru_cache(maxsize=8)
def _dft_filters(n_fft: int, win_length: int, device) -> torch.Tensor:
    return torch.from_numpy(_dft_filters_np(n_fft, win_length)).to(device)


@contextlib.contextmanager
def _tf32(allow: bool = False):
    """Products with TF32 allowed or not, whatever a caller set globally:
    full f32 unless ``allow`` (TF32 keeps about three decimal digits)."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = allow
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def stft_conv(wav: torch.Tensor, cfg: MelConfig = MelConfig()) -> torch.Tensor:
    """Real/imag STFT [B, 2F, T] of a waveform [B, L] as ONE f32 product of
    Hann-windowed DFT filters with the centred frames of a statically
    reflect-padded buffer. Rows 0..F-1 are the real part, rows F..2F-1
    the imaginary part. Frames near a shorter sample's own valid-length
    boundary are patched by the caller (:func:`_boundary_power_fix`)."""
    wav = wav.to(torch.float32)
    B, L = wav.shape
    pad = cfg.n_fft // 2
    T = cfg.num_frames(L)
    zeros_len = max(cfg.win_length, (T - 1) * cfg.hop_length
                    + cfg.win_length - 2 * pad - L)
    left = wav[:, 1: pad + 1].flip(1)
    right = wav[:, L - pad - 1: L - 1].flip(1)
    wavp = torch.cat([left, wav, right, wav.new_zeros(B, zeros_len)], 1)
    frames = wavp.unfold(1, cfg.win_length, cfg.hop_length)[:, :T]
    filt = _dft_filters(cfg.n_fft, cfg.win_length, wav.device)
    if cfg.stft_precision not in ("high", "highest", "default"):
        raise ValueError(f"unknown stft_precision {cfg.stft_precision!r}")
    with _tf32(cfg.stft_precision == "default"):
        return torch.matmul(filt, frames.transpose(1, 2))  # [B, 2F, T]


def _boundary_power_fix(wav: torch.Tensor, length: torch.Tensor,
                        cfg: MelConfig):
    """Exact power [B, K, F] of the K frames whose analysis window crosses
    each sample's dynamic valid-length boundary (reflect padding at the
    sample's own end, as the reference computes mel on exact-length
    crops), plus their start frame t0 [B].

    One contiguous S-sample buffer is gathered per sample; a position
    past the boundary reads its reflection ``2*(length-1) - g`` from the
    same buffer, or zero where the reflection falls outside it (such
    frames lie at or past frame ``length // hop + 1`` and are masked by
    every caller). Assumes length >= win_length."""
    B, L = wav.shape
    pad = cfg.n_fft // 2
    T = cfg.num_frames(L)
    hop = cfg.hop_length
    win = cfg.win_length
    K = 6  # windows crossing the boundary: <= ceil((pad+hop)/hop)+1
    dev = wav.device
    length = length.to(device=dev, dtype=torch.int64)
    t0 = torch.clamp(torch.div(length - (win - pad - hop + 1), hop,
                               rounding_mode="floor"), 0, max(T - K, 0))
    S = win + (K - 1) * hop  # contiguous samples covering all K windows
    wav = wav.to(torch.float32)
    left = wav[:, 1: pad + 1].flip(1)
    wavp = torch.cat([left, wav, wav.new_zeros(B, S)], 1)
    starts = t0 * hop  # buffer start in padded coordinates
    pos = torch.arange(S, device=dev)
    buf = torch.gather(wavp, 1, starts[:, None] + pos[None, :])
    g = (starts - pad)[:, None] + pos[None, :]  # global sample index
    c = 2 * (length - 1) - 2 * (starts - pad)
    src = c[:, None] - pos[None, :]  # buffer position of the reflection
    inside = (src >= 0) & (src < S)
    refl = torch.where(inside, torch.gather(buf, 1, src.clamp(0, S - 1)),
                       buf.new_zeros(()))
    patched = torch.where(g < length[:, None], buf, refl)
    frames = torch.stack(
        [patched[:, k * hop: k * hop + win] for k in range(K)], 1)
    frames = frames * hann_window(win, dev)
    spec = torch.fft.rfft(frames, n=cfg.n_fft, dim=-1)
    fix = spec.real ** 2 + spec.imag ** 2  # [B, K, F]
    return fix, t0


def power_spectrogram(wav: torch.Tensor,
                      length: Optional[torch.Tensor] = None,
                      cfg: MelConfig = MelConfig()) -> torch.Tensor:
    """Power spectrogram |STFT|^2 [B, T, n_freqs]: the f32 STFT with the
    boundary frames of each sample patched (per-sample reflect padding)."""
    out = stft_conv(wav, cfg)
    F = cfg.n_freqs
    power = (out[:, :F] ** 2 + out[:, F:] ** 2).transpose(1, 2)  # [B, T, F]
    if length is None:
        return power
    fix, t0 = _boundary_power_fix(
        wav, torch.as_tensor(length, device=wav.device), cfg)
    rows = t0[:, None, None] + torch.arange(fix.shape[1],
                                            device=wav.device)[:, None]
    return power.scatter(1, rows.expand_as(fix), fix)


def minmax_scale(x: torch.Tensor, cfg: MelConfig = MelConfig()) -> torch.Tensor:
    return (x - cfg.mel_min) / (cfg.mel_max - cfg.mel_min) * 2.0 - 1.0


def _topdb_minmax(db: torch.Tensor, cfg: MelConfig,
                  valid: Optional[torch.Tensor], normalize: bool):
    """Per-sample top_db clamp over the valid frames (+ MinMax)."""
    if cfg.top_db is not None:
        if valid is not None:
            mask = (torch.arange(db.shape[-1], device=db.device)[None, None, :]
                    < valid[:, None, None])
            masked = torch.where(mask, db, db.new_full((), -float("inf")))
        else:
            masked = db
        max_db = masked.amax(dim=(1, 2), keepdim=True)
        db = torch.maximum(db, max_db - cfg.top_db)
    if normalize:
        db = minmax_scale(db, cfg)
    return db


def log_melspec(wav: torch.Tensor, length: Optional[torch.Tensor] = None,
                cfg: MelConfig = MelConfig(),
                normalize: bool = True, plain: bool = False) -> torch.Tensor:
    """Waveform [B, L] (+ optional valid sample counts [B]) -> normalized
    log-mel spectrogram [B, n_mels, T], T = 1 + L // hop. Frames past a
    sample's valid count are garbage that callers mask. ``plain=True``
    takes the mel kernel's plain version on any device."""
    if wav.ndim == 1:
        wav = wav[None]
    fb = mel_filterbank(cfg, wav.device)
    to_db = stft_to_mel_db_ref if plain else stft_to_mel_db
    db = to_db(stft_conv(wav, cfg), fb, amin=cfg.amin)
    valid = None
    if length is not None:
        length = torch.as_tensor(length, device=wav.device)
        valid = torch.div(length, cfg.hop_length, rounding_mode="floor") + 1
        fix_p, t0 = _boundary_power_fix(wav, length, cfg)
        with _tf32():
            fix_mel = torch.einsum("bkf,fm->bmk", fix_p, fb)
        fix_db = 10.0 * torch.log10(torch.clamp(fix_mel, min=cfg.amin))
        cols = t0[:, None, None] + torch.arange(
            fix_db.shape[-1], device=wav.device)
        db = db.scatter(2, cols.expand_as(fix_db), fix_db)
    return _topdb_minmax(db, cfg, valid, normalize)
