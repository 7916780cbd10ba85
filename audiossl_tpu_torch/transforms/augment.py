"""On-device augmentation of the pretraining step (PyTorch port).

Port of the parts of ``audiossl_tpu/transforms/augment.py`` that the
ATST-Frame and ATST-Clip steps run: waveform dequantization, random crop
lengths, the batched random crop, BYOL-A log-mixup-exp with an in-batch
partner, and RandomResizeCrop (its pure freq-warp form for ATST-Frame, the
general virtual-canvas form for ATST-Clip); and the finetuning step's
SpecAugment masks (torchaudio's frequency and time masking). Every
augmentation is split in two:

* a *draw* function makes its random numbers on the device from a
  ``torch.Generator`` (uniforms in [0, 1), partner shifts);
* an *apply* function takes those draws as tensors and does the rest.

The apply functions reproduce the JAX functions exactly when handed the
numbers JAX's keys give, which is how the tests hold them against JAX;
``torch.Generator`` and ``jax.random`` give different numbers from one
seed. Semantics are the JAX package's: the partner of sample i is
``(i + shift) % B`` in the global batch (across ranks under a process
group), padded frames are left untouched, and the crop and
freq warp honour each sample's valid length.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from audiossl_tpu_torch.ops.interpolate import (sample_bicubic_2d,
                                                sample_bicubic_rows)
from audiossl_tpu_torch.parallel.mesh import all_gather_rows, local_rows

_EPS32 = float(torch.finfo(torch.float32).eps)


def rows_of(x, sl: slice):
    """Rows ``sl`` of a draw: a tensor, a tuple of them, or None."""
    if x is None:
        return None
    if isinstance(x, tuple):
        return tuple(t[sl] for t in x)
    return x[sl]


def view_major_rows(m: Optional[torch.Tensor], batch: int,
                    sl: slice) -> Optional[torch.Tensor]:
    """Rows ``sl`` of each view of per-sequence draws [..., S] stacked
    view-major over S = 2 ``batch`` (or of the one view, S = ``batch``),
    still view-major."""
    if m is None or m.shape[-1] == batch:
        return None if m is None else m[..., sl]
    return torch.cat([m[..., :batch][..., sl], m[..., batch:][..., sl]], -1)


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


def _uniform(u: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """Uniforms u in [0, 1) mapped to [lo, hi) as ``jax.random.uniform``
    maps its own: ``max(lo, u * (hi - lo) + lo)`` in f32."""
    lo, hi = _f32(lo), _f32(hi)
    return torch.clamp(u * _f32(hi - lo) + lo, min=lo)


def sample_crop_lengths(u: Optional[torch.Tensor], batch: int, min_s: float,
                        max_s: float, sr: int = 16000,
                        device=None) -> torch.Tensor:
    """Per-sample crop lengths in samples [B], uniform in [min_s, max_s]
    seconds from the uniforms u [B] (not read when min_s == max_s: every
    crop is ``int(min_s * sr)`` long)."""
    if min_s == max_s:
        return torch.full((batch,), int(min_s * sr), dtype=torch.long,
                          device=device)
    return (_uniform(u, min_s, max_s) * float(sr)).long()


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
              valid_frames: Optional[torch.Tensor] = None,
              pool: Optional[torch.Tensor] = None) -> torch.Tensor:
    """BYOL-A log-mixup-exp with an in-batch partner: spec [B, F, T] ->
    log((1 - a) exp(x) + a exp(z) + eps), z = pool[(i + shift) % N];
    frames at or past ``valid_frames`` keep their values. ``pool`` [N, F,
    T] is the global batch, whose rows ``[r B, (r + 1) B)`` are this
    rank's ``spec`` (i counts from r B): by default every rank's ``spec``
    gathered (``parallel.all_gather_rows``), ``spec`` itself in one
    process."""
    B = spec.shape[0]
    if pool is None:
        pool = all_gather_rows(spec)
    i = torch.arange(B, device=spec.device)
    if pool.shape[0] != B:
        i = i + local_rows(pool.shape[0]).start
    z = pool[(i + shift) % pool.shape[0]]
    a = a[:, None, None]
    mixed = torch.log((1.0 - a) * torch.exp(spec) + a * torch.exp(z)
                      + _EPS32)
    if valid_frames is not None:
        pos = torch.arange(spec.shape[-1], device=spec.device)[None, None, :]
        mixed = torch.where(pos < valid_frames[:, None, None], mixed, spec)
    return mixed


def draw_resize_crop(gen: torch.Generator, batch: int, device,
                     time: bool = False):
    """(box height uniforms [B], box row uniforms [B]) for the freq warp,
    whose time box is the identity; with ``time`` also (box width
    uniforms [B], box column uniforms [B]) for the general form."""
    n = 4 if time else 2
    return tuple(torch.rand(batch, generator=gen, device=device)
                 for _ in range(n))


def random_resize_crop(spec: torch.Tensor, h_u: torch.Tensor,
                       iy_u: torch.Tensor, w_u: Optional[torch.Tensor] = None,
                       ix_u: Optional[torch.Tensor] = None,
                       virtual_crop_scale: Sequence[float] = (1.0, 1.0),
                       freq_scale: Sequence[float] = (0.6, 1.5),
                       time_scale: Sequence[float] = (1.0, 1.0),
                       valid_frames: Optional[torch.Tensor] = None):
    """The BYOL-A RandomResizeCrop, batched (JAX ``random_resize_crop``).

    Per sample: the [F, T] spectrogram is placed on a zero canvas of
    (F * vc_f, T * vc_t), centred in the sample's virtual width
    ``CWv = max(int(W * vc_t), W)`` (W = its valid width); a box of height
    h = U(freq_scale) * F at row iy and width w = U(time_scale) * W at
    column ix < CWv - w + 1 is bicubic-resized back to (F, W)
    (align_corners=True, taps clamped to the box); frames past W are zero.
    The draws are the uniforms h_u, iy_u, w_u, ix_u [B]. With canvas and
    time scale (1, 1) (the ATST-Frame freq warp) the time mapping is the
    identity: only rows are sampled and w_u, ix_u are not read."""
    B, F, T = spec.shape
    dev = spec.device
    CH = int(F * virtual_crop_scale[0])
    CW = int(T * virtual_crop_scale[1])
    time_identity = (tuple(virtual_crop_scale) == (1.0, 1.0)
                     and tuple(time_scale) == (1.0, 1.0))
    if valid_frames is None:
        W = torch.full((B,), T, device=dev, dtype=torch.long)
    else:
        W = torch.clamp(valid_frames.long(), 1, T)
    hf = _uniform(h_u, *freq_scale)
    h = torch.clamp((hf * float(F)).int(), 1, CH)
    iy = (iy_u * (CH - h + 1).float()).int()
    jF = torch.arange(F, device=dev, dtype=torch.float32)[None, :]
    ys = iy[:, None].float() + jF * ((h.float() - 1.0) / max(F - 1, 1))[:, None]
    if time_identity:
        out = sample_bicubic_rows(spec, ys, iy, iy + h - 1)
    else:
        if w_u is None or ix_u is None:
            raise ValueError("random_resize_crop: a time box needs w_u and "
                             "ix_u")
        # the virtual canvas extent and centred placement, per sample
        CWv = torch.maximum((W.float() * virtual_crop_scale[1]).long(), W)
        x0 = torch.clamp((CWv - W) // 2, 0, CW - T)
        y0 = (CH - F) // 2
        cols = (x0[:, None] + torch.arange(T, device=dev))[:, None, :]
        rows = spec.new_zeros(B, F, CW).scatter(2, cols.expand(B, F, T), spec)
        canvas = torch.nn.functional.pad(rows, (0, 0, y0, CH - F - y0))
        wf = _uniform(w_u, *time_scale)
        w = torch.minimum(torch.clamp((wf * W.float()).long(), min=1), CWv)
        ix = (ix_u * (CWv - w + 1).float()).long()
        jT = torch.arange(T, device=dev, dtype=torch.float32)[None, :]
        xs = ix[:, None].float() + jT * (
            (w.float() - 1.0) / torch.clamp(W.float() - 1.0, min=1.0))[:, None]
        out = sample_bicubic_2d(canvas, ys, xs, iy, iy + h - 1, ix, ix + w - 1)
    pos = torch.arange(T, device=dev)[None, None, :]
    return torch.where(pos < W[:, None, None], out, 0.0)


def draw_mask(gen: torch.Generator, batch: int, max_width: int, device):
    """(mask widths [B] in [0, max_width), start uniforms [B]) for
    :func:`freq_mask` or :func:`time_mask`."""
    return (torch.randint(0, max_width, (batch,), generator=gen,
                          device=device),
            torch.rand(batch, generator=gen, device=device))


def freq_mask(spec: torch.Tensor, width: torch.Tensor,
              u: torch.Tensor) -> torch.Tensor:
    """torchaudio ``FrequencyMasking`` (JAX ``freq_mask``, one mask): per
    sample the band [f0, f0 + f) of spec [B, F, T] set to 0, f = width [B],
    f0 = ``int(u * (F - f + 1))`` in f32."""
    F = spec.shape[1]
    f0 = (u * (F - width + 1).float()).int()
    pos = torch.arange(F, device=spec.device)[None, :]
    band = (pos >= f0[:, None]) & (pos < (f0 + width)[:, None])
    return torch.where(band[:, :, None], 0.0, spec)


def time_mask(spec: torch.Tensor, width: torch.Tensor, u: torch.Tensor,
              valid_frames: Optional[torch.Tensor] = None) -> torch.Tensor:
    """torchaudio ``TimeMasking`` on the last axis (JAX ``time_mask``, one
    mask): per sample the frames [t0, t0 + t) set to 0, t = width [B], t0 =
    ``int(u * max(W - t + 1, 1))`` in f32 with W the sample's
    ``valid_frames`` (default T)."""
    B, _, T = spec.shape
    hi = (torch.full((B,), T, device=spec.device) if valid_frames is None
          else valid_frames.long())
    t0 = (u * torch.clamp(hi - width + 1, min=1).float()).int()
    pos = torch.arange(T, device=spec.device)[None, :]
    band = (pos >= t0[:, None]) & (pos < (t0 + width)[:, None])
    return torch.where(band[:, None, :], 0.0, spec)
