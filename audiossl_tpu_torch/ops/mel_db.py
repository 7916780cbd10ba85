"""Fused |STFT|^2 -> mel filterbank -> dB (kernel K1).

Port of ``audiossl_tpu/ops/pallas_mel.py:39 stft_to_mel_db``. The kernel
(``csrc/mel_db.cu``) reads the interleaved real/imag STFT once and
writes the mel dB once; the [B, F, T] power array never reaches device
memory. The per-sample top-dB clamp and MinMax need a global max per
sample and stay in ``ops.melspec.log_melspec``.
"""
from __future__ import annotations

import math

import torch

from audiossl_tpu_torch.kernels import build as kb

_LOG10_SCALE = 10.0 / math.log(10.0)


def stft_to_mel_db_ref(stft: torch.Tensor, fb: torch.Tensor,
                       amin: float = 1e-10) -> torch.Tensor:
    """Plain version of :func:`stft_to_mel_db`: stft [B, 2F, T] (cos rows
    then -sin rows), fb [F, n_mels] -> unclamped mel dB [B, n_mels, T]."""
    F = stft.shape[1] // 2
    re, im = stft[:, :F], stft[:, F:]
    power = re * re + im * im  # [B, F, T]
    mel = torch.einsum("fm,bft->bmt", fb, power)
    return _LOG10_SCALE * torch.log(torch.clamp(mel, min=amin))


def stft_to_mel_db(stft: torch.Tensor, fb: torch.Tensor,
                   amin: float = 1e-10) -> torch.Tensor:
    """stft [B, 2F, T] f32, fb [F, n_mels] f32 -> mel dB [B, n_mels, T].

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel (or raises)."""
    if stft.device.type == "cpu":
        return stft_to_mel_db_ref(stft, fb, amin)
    kb.require_cuda("stft_to_mel_db", stft, fb)
    B, F2, T = stft.shape
    F, n_mels = fb.shape
    if stft.dtype != torch.float32 or fb.dtype != torch.float32:
        raise ValueError("stft_to_mel_db: the kernel takes f32 inputs")
    if B > 65535:  # one grid.z slice per clip
        raise ValueError(f"stft_to_mel_db: {B} clips, at most 65535")
    if F2 != 2 * F:
        raise ValueError(f"stft_to_mel_db: stft has {F2} rows, "
                         f"fb has {F} frequencies")
    out = torch.empty(B, n_mels, T, device=stft.device, dtype=torch.float32)
    kb.launch("mel_db", stft.device, kb.ptr(stft), kb.ptr(fb), kb.ptr(out),
              B, F, T, n_mels, amin)
    return out
