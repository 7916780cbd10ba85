"""On-device augmentation of the pretraining step (PyTorch port).

Port of the parts of ``audiossl_tpu/transforms/augment.py`` that the
ATST-Frame step runs: waveform dequantization, the batched random crop,
BYOL-A log-mixup-exp with an in-batch partner, and RandomResizeCrop in its
pure freq-warp form. Every augmentation is split in two:

* a *draw* function makes its random numbers on the device from a
  ``torch.Generator`` (uniforms in [0, 1), partner shifts);
* an *apply* function takes those draws as tensors and does the rest.

The apply functions reproduce the JAX functions exactly when handed the
numbers JAX's keys give, which is how the tests hold them against JAX;
``torch.Generator`` and ``jax.random`` give different numbers from one
seed. Semantics are the JAX package's: the partner of sample i is
``(i + shift) % B``, padded frames are left untouched, and the crop and
freq warp honour each sample's valid length.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from audiossl_tpu_torch.ops.interpolate import sample_bicubic_rows

_EPS32 = float(torch.finfo(torch.float32).eps)


def _f32(v: float) -> float:
    """The f32 rounding of v, as a Python float."""
    return float(np.float32(v))


# --------------------------------------------------------------------- #
# waveform-level
# --------------------------------------------------------------------- #
def wav_to_f32(wav: torch.Tensor) -> torch.Tensor:
    """int16 samples -> f32 in [-1, 1) by the exact 1/32768 scale; float
    inputs are cast to f32."""
    if wav.dtype == torch.int16:
        return wav.float() * (1.0 / 32768.0)
    return wav.float()


def draw_crop(gen: torch.Generator, batch: int, device) -> torch.Tensor:
    """Crop-start uniforms [B] for :func:`random_crop_wav`."""
    return torch.rand(batch, generator=gen, device=device)


def random_crop_wav(wav: torch.Tensor, valid: torch.Tensor,
                    crop_len: torch.Tensor, out_len: int,
                    u: Optional[torch.Tensor] = None):
    """Batched random crop of zero-padded waveforms wav [B, L] with valid
    sample counts [B] to crops of crop_len [B] (<= out_len) samples.

    Returns (crops [B, out_len], out_valid [B]): a random start
    ``floor(u * (max_start + 1))`` when the clip is longer than the crop;
    a shorter clip is kept whole and zero-padded. When the buffer is as
    wide as the crop the only start is 0 and ``u`` is not read."""
    B, L = wav.shape
    crop_len = torch.clamp(crop_len, max=out_len)
    out_valid = torch.minimum(crop_len, valid)
    pos = torch.arange(out_len, device=wav.device)[None, :]
    if out_len == L:
        return torch.where(pos < out_valid[:, None], wav, 0.0), out_valid
    max_start = torch.clamp(valid - crop_len, min=0)
    start = (u * (max_start + 1).float()).long()
    start = torch.minimum(start, max_start)
    start = torch.clamp(start, 0, max(L - out_len, 0))
    crops = torch.gather(wav, 1, start[:, None] + pos)
    return torch.where(pos < out_valid[:, None], crops, 0.0), out_valid


# --------------------------------------------------------------------- #
# spectrogram-level
# --------------------------------------------------------------------- #
def draw_mixup(gen: torch.Generator, batch: int, ratio: float, device):
    """(a [B] = ratio * U(0, 1), partner shift [B] in [1, B - 1])."""
    a = _f32(ratio) * torch.rand(batch, generator=gen, device=device)
    shift = torch.randint(1, max(batch, 2), (batch,), generator=gen,
                          device=device)
    return a, shift


def mixup_log(spec: torch.Tensor, a: torch.Tensor, shift: torch.Tensor,
              valid_frames: Optional[torch.Tensor] = None) -> torch.Tensor:
    """BYOL-A log-mixup-exp with an in-batch partner: spec [B, F, T] ->
    log((1 - a) exp(x) + a exp(z) + eps), z = spec[(i + shift) % B];
    frames at or past ``valid_frames`` keep their values."""
    B = spec.shape[0]
    z = spec[(torch.arange(B, device=spec.device) + shift) % B]
    a = a[:, None, None]
    mixed = torch.log((1.0 - a) * torch.exp(spec) + a * torch.exp(z)
                      + _EPS32)
    if valid_frames is not None:
        pos = torch.arange(spec.shape[-1], device=spec.device)[None, None, :]
        mixed = torch.where(pos < valid_frames[:, None, None], mixed, spec)
    return mixed


def draw_resize_crop(gen: torch.Generator, batch: int, device):
    """(box height uniforms [B], box offset uniforms [B]) for the freq warp:
    the time box of :func:`random_resize_crop` is the identity."""
    h_u = torch.rand(batch, generator=gen, device=device)
    iy_u = torch.rand(batch, generator=gen, device=device)
    return h_u, iy_u


def random_resize_crop(spec: torch.Tensor, h_u: torch.Tensor,
                       iy_u: torch.Tensor,
                       virtual_crop_scale: Sequence[float] = (1.0, 1.0),
                       freq_scale: Sequence[float] = (0.6, 1.5),
                       time_scale: Sequence[float] = (1.0, 1.0),
                       valid_frames: Optional[torch.Tensor] = None):
    """The BYOL-A RandomResizeCrop in its pure freq-warp form (virtual
    canvas (1, 1), time scale (1, 1), the ATST-Frame recipe): per sample a
    box of height h = U(freq_scale) * F at row iy is bicubic-resized back
    to F rows (align_corners=True, taps clamped to the box); frames past
    the valid width are zero. Other canvas or time scales are not ported
    (they raise)."""
    if tuple(virtual_crop_scale) != (1.0, 1.0) or tuple(time_scale) != (1.0,
                                                                        1.0):
        raise NotImplementedError("only the freq-warp form (canvas and time "
                                  "scale (1, 1)) is ported")
    B, F, T = spec.shape
    dev = spec.device
    CH = F
    if valid_frames is None:
        W = torch.full((B,), T, device=dev, dtype=torch.long)
    else:
        W = torch.clamp(valid_frames.long(), 1, T)
    lo, hi = _f32(freq_scale[0]), _f32(freq_scale[1])
    hf = torch.clamp(h_u * _f32(hi - lo) + lo, min=lo)  # U(lo, hi), f32
    h = torch.clamp((hf * float(F)).int(), 1, CH)
    iy = (iy_u * (CH - h + 1).float()).int()
    jF = torch.arange(F, device=dev, dtype=torch.float32)[None, :]
    ys = iy[:, None].float() + jF * ((h.float() - 1.0) / max(F - 1, 1))[:, None]
    out = sample_bicubic_rows(spec, ys, iy, iy + h - 1)
    pos = torch.arange(T, device=dev)[None, None, :]
    return torch.where(pos < W[:, None, None], out, 0.0)
