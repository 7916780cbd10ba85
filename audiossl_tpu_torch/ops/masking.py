"""Token masks for masked teacher-student pretraining (PyTorch port).

Port of ``audiossl_tpu/ops/masking.py``: fairseq-style ``block`` masks
(fixed-length spans, randomized span-count rounding, without-replacement
starts, the short-sequence fallback), ``random`` masks (exactly
ceil(ratio * valid) tokens) and ``uniform`` span masks, on the device with
static shapes and per-sample valid lengths.

As in ``transforms/augment.py`` each mask is a draw (:func:`draw_token_mask`:
uniforms and span lengths from a ``torch.Generator``) and an apply
(:func:`make_token_mask`), so the tests can hand JAX's draws to the apply.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch


def _span_slots(ratio: float, num_tokens: int, span: int,
                min_masks: int) -> int:
    """Worst-case span count: the randomized rounding can add one."""
    return max(min_masks, int(ratio * num_tokens / span) + 1)


def draw_token_mask(gen: torch.Generator, batch: int, num_tokens: int,
                    ratio: float, mask_type: str = "block", span: int = 5,
                    min_span: int = 2, min_masks: int = 2,
                    device=None) -> Dict[str, torch.Tensor]:
    """The random numbers :func:`make_token_mask` needs for ``mask_type``."""
    def rand(*shape):
        return torch.rand(*shape, generator=gen, device=device)

    if mask_type == "random":
        return {"u": rand(batch, num_tokens)}
    if mask_type == "block":
        return {"u_round": rand(batch), "u_starts": rand(batch, num_tokens)}
    if mask_type == "uniform":
        K = _span_slots(ratio, num_tokens, span, min_masks)
        return {"u_round": rand(batch),
                "lengths": torch.randint(min_span, 2 * span + 1, (batch, K),
                                         generator=gen, device=device),
                "u_starts": rand(batch, num_tokens)}
    raise ValueError(f"unknown mask_type {mask_type!r}")


def _valid_arr(valid, batch, num_tokens, device):
    if valid is None:
        return torch.full((batch,), num_tokens, device=device,
                          dtype=torch.long)
    return valid.long()


def random_token_mask(u: torch.Tensor, ratio: float,
                      valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[B, T] bool: exactly ceil(ratio * valid) of the valid tokens, the
    ones with the smallest u, and every token past the valid length."""
    B, T = u.shape
    valid = _valid_arr(valid, B, T, u.device)
    in_valid = torch.arange(T, device=u.device)[None, :] < valid[:, None]
    u = torch.where(in_valid, u, 2.0)
    rank = torch.argsort(torch.argsort(u, dim=-1, stable=True), dim=-1,
                         stable=True)
    k = torch.ceil(ratio * valid.float()).long()
    return torch.where(in_valid, rank < k[:, None], True)


def _span_count(u_round, ratio, span, min_masks, valid):
    """fairseq's randomized rounding int(ratio * valid / span + U(0, 1))."""
    x = ratio * valid.float() / span
    return torch.clamp(torch.floor(x + u_round).long(), min=min_masks)


def _start_range(valid, min_len, n_spans, num_tokens):
    """fairseq's start range ``valid - min_len``, widened to n_spans + 1
    when the starts do not fit, clamped to [1, num_tokens]."""
    rng = valid - min_len
    rng = torch.where(rng <= n_spans, n_spans + 1, rng)
    return torch.clamp(rng, 1, num_tokens)


def _span_starts(u_starts, K, hi):
    """K starts per sample without replacement from [0, hi): the positions
    of the K smallest uniforms below hi; overflow clamps to hi - 1."""
    T = u_starts.shape[1]
    u = torch.where(torch.arange(T, device=u_starts.device)[None, :]
                    < hi[:, None], u_starts, 2.0)
    order = torch.argsort(u, dim=-1, stable=True)
    return torch.minimum(order[:, :K], hi[:, None] - 1)


def _span_mask(num_tokens, starts, lengths):
    """Union of the spans [start, start + length) per sample -> [B, T]."""
    tok = torch.arange(num_tokens, device=starts.device)[None, None, :]
    s = starts[:, :, None]
    return ((tok >= s) & (tok < s + lengths[:, :, None])).any(dim=1)


def block_token_mask(u_round, u_starts, ratio: float, span: int = 5,
                     min_masks: int = 2,
                     valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """fairseq "static" block masking: fixed span length, overlapping spans
    allowed, without-replacement starts in [0, valid - span) with the
    short-sequence fallback, mask indices clipped at the valid length."""
    B, T = u_starts.shape
    valid = _valid_arr(valid, B, T, u_starts.device)
    K = _span_slots(ratio, T, span, min_masks)
    n_spans = _span_count(u_round, ratio, span, min_masks, valid)
    hi = _start_range(valid, span, n_spans, T)
    starts = _span_starts(u_starts, K, hi)
    active = torch.arange(K, device=valid.device)[None, :] < n_spans[:, None]
    lengths = torch.where(active, span, 0)
    m = _span_mask(T, starts, lengths)
    return m & (torch.arange(T, device=valid.device)[None, :] < valid[:, None])


def uniform_span_mask(u_round, lengths, u_starts, ratio: float,
                      span: int = 5, min_span: int = 2, min_masks: int = 2,
                      valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """fairseq "uniform" masking: span lengths drawn in [min_span, 2 span]
    (``lengths`` [B, K]), the span count divided by ``span``, the start
    range from the shortest active span."""
    B, T = u_starts.shape
    valid = _valid_arr(valid, B, T, u_starts.device)
    K = lengths.shape[1]
    n_spans = _span_count(u_round, ratio, span, min_masks, valid)
    active = torch.arange(K, device=valid.device)[None, :] < n_spans[:, None]
    min_len = torch.where(active, lengths, 2 * span + 1).min(dim=1).values
    hi = _start_range(valid, min_len, n_spans, T)
    starts = _span_starts(u_starts, K, hi)
    m = _span_mask(T, starts, torch.where(active, lengths, 0))
    return m & (torch.arange(T, device=valid.device)[None, :] < valid[:, None])


def make_token_mask(draws: Dict[str, torch.Tensor], ratio: float,
                    mask_type: str = "block", span: int = 5,
                    min_span: int = 2, min_masks: int = 2,
                    valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Dispatch on ``mask_type`` with the draws of :func:`draw_token_mask`."""
    if mask_type == "random":
        return random_token_mask(draws["u"], ratio, valid)
    if mask_type == "block":
        return block_token_mask(draws["u_round"], draws["u_starts"], ratio,
                                span, min_masks, valid)
    if mask_type == "uniform":
        return uniform_span_mask(draws["u_round"], draws["lengths"],
                                 draws["u_starts"], ratio, span, min_span,
                                 min_masks, valid)
    raise ValueError(f"unknown mask_type {mask_type!r}")
