"""Bicubic resampling (PyTorch port of ``audiossl_tpu/ops/interpolate.py``).

The Keys cubic convolution weights with A = -0.75 (torch's choice) and
edge-clamped taps, as separable gathers, for two users:

* :func:`resize_bicubic`, a static-shape resize for the position
  embeddings of ``pos_type="interpolate"`` (reference
  ``F.interpolate(mode='bicubic')``, align_corners=False);
* per-sample bicubic sampling at traced coordinates with per-sample edge
  clamps (the crop box) for the RandomResizeCrop augmentation: along the
  frequency axis only (the freq warp), or along time and then frequency.
"""
from __future__ import annotations

import torch

_A = -0.75  # torch cubic convolution constant


def _cubic_weights(t: torch.Tensor) -> torch.Tensor:
    """Weights [..., 4] for taps at offsets (-1, 0, 1, 2) given the
    fractional position t in [0, 1). Keys kernel: |x| <= 1 ->
    (A+2)|x|^3 - (A+3)|x|^2 + 1; 1 < |x| < 2 -> A|x|^3 - 5A|x|^2 + 8A|x| - 4A."""
    def k01(x):
        return ((_A + 2.0) * x - (_A + 3.0)) * x * x + 1.0

    def k12(x):
        return ((_A * x - 5.0 * _A) * x + 8.0 * _A) * x - 4.0 * _A

    return torch.stack([k12(t + 1.0), k01(t), k01(1.0 - t), k12(2.0 - t)],
                       dim=-1)


def sample_bicubic_rows(x: torch.Tensor, ys: torch.Tensor, y_lo: torch.Tensor,
                        y_hi: torch.Tensor) -> torch.Tensor:
    """Per-sample bicubic sampling of x [B, H, W] along H at coordinates
    ys [B, OH], taps clamped to [y_lo, y_hi] per sample -> [B, OH, W]."""
    B, _, W = x.shape
    fy = torch.floor(ys)
    wy = _cubic_weights(ys - fy)  # [B, OH, 4]
    by = fy.long()
    lo, hi = y_lo.long()[:, None], y_hi.long()[:, None]
    out = None
    for m, off in enumerate((-1, 0, 1, 2)):
        idx = torch.minimum(torch.maximum(by + off, lo), hi)  # [B, OH]
        tap = torch.gather(x, 1, idx[:, :, None].expand(B, idx.shape[1], W))
        contrib = tap * wy[:, :, m][:, :, None]
        out = contrib if out is None else out + contrib
    return out


def sample_bicubic_2d(canvas: torch.Tensor, ys: torch.Tensor,
                      xs: torch.Tensor, y_lo: torch.Tensor,
                      y_hi: torch.Tensor, x_lo: torch.Tensor,
                      x_hi: torch.Tensor) -> torch.Tensor:
    """Per-sample bicubic sampling of canvas [B, H, W] at coordinates ys
    [B, OH] and xs [B, OW], taps clamped per sample to [y_lo, y_hi] and
    [x_lo, x_hi] (inclusive, the crop box) -> [B, OH, OW]. Separable: along
    W first, then along H, as the JAX function."""
    B, H, _ = canvas.shape
    OW = xs.shape[1]
    fx = torch.floor(xs)
    wx = _cubic_weights(xs - fx)  # [B, OW, 4]
    bx = fx.long()
    lo, hi = x_lo.long()[:, None], x_hi.long()[:, None]
    acc = None
    for m, off in enumerate((-1, 0, 1, 2)):
        idx = torch.minimum(torch.maximum(bx + off, lo), hi)  # [B, OW]
        tap = torch.gather(canvas, 2, idx[:, None, :].expand(B, H, OW))
        contrib = tap * wx[:, None, :, m]
        acc = contrib if acc is None else acc + contrib
    return sample_bicubic_rows(acc, ys, y_lo, y_hi)


def resize_bicubic(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Resize the last two axes of x to (out_h, out_w) as the JAX
    function does with align_corners=False (torch's bicubic source
    coordinates, taps clamped to the edges): along H, then along W."""
    *_, H, W = x.shape

    def coords(in_n, out_n):
        i = torch.arange(out_n, dtype=torch.float32, device=x.device)
        return (i + 0.5) * (in_n / out_n) - 0.5

    y = _sample_axis(x, coords(H, out_h), x.ndim - 2)
    return _sample_axis(y, coords(W, out_w), x.ndim - 1)


def _sample_axis(x: torch.Tensor, coords: torch.Tensor, axis: int):
    """Sampling along ``axis`` at coordinates [O] shared by every row."""
    n = x.shape[axis]
    f = torch.floor(coords)
    w = _cubic_weights(coords - f)  # [O, 4]
    base = f.long()
    shape = [1] * x.ndim
    shape[axis] = coords.shape[0]
    out = None
    for m, off in enumerate((-1, 0, 1, 2)):
        tap = torch.index_select(x, axis, torch.clamp(base + off, 0, n - 1))
        contrib = tap * w[:, m].reshape(shape)
        out = contrib if out is None else out + contrib
    return out
