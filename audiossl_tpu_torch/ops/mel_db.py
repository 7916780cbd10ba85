"""Fused |STFT|^2 -> mel filterbank -> dB (kernel K1).

Port of ``audiossl_tpu/ops/pallas_mel.py:39 stft_to_mel_db``. The kernel
(``csrc/mel_db.cu``) reads the interleaved real/imag STFT once and
writes the mel dB once; the [B, F, T] power array never reaches device
memory. It walks each mel's band of the filterbank only (the recipe's
triangles hold 3% non-zeros), through a band table that
:func:`band_table` builds once per filterbank and the wrapper keeps on
the device. The per-sample top-dB clamp and MinMax need a global max per
sample and stay in ``ops.melspec.log_melspec``.
"""
from __future__ import annotations

import math
from collections import OrderedDict

import numpy as np
import torch

from audiossl_tpu_torch.kernels import build as kb

_LOG10_SCALE = 10.0 / math.log(10.0)
# csrc/mel_db.cu's pair word: the bin in the low 16 bits, then the flags
BIN_MASK, LAST, EMPTY = 0xFFFF, 1 << 16, 1 << 17
GROUP_PAIRS = 32  # pairs a group of mels takes, about (one block's work)
_TABLES: "OrderedDict[tuple, tuple]" = OrderedDict()
_MAX_TABLES = 8


def stft_to_mel_db_ref(stft: torch.Tensor, fb: torch.Tensor,
                       amin: float = 1e-10) -> torch.Tensor:
    """Plain version of :func:`stft_to_mel_db`: stft [B, 2F, T] (cos rows
    then -sin rows), fb [F, n_mels] -> unclamped mel dB [B, n_mels, T]."""
    F = stft.shape[1] // 2
    re, im = stft[:, :F], stft[:, F:]
    power = re * re + im * im  # [B, F, T]
    mel = torch.einsum("fm,bft->bmt", fb, power)
    return _LOG10_SCALE * torch.log(torch.clamp(mel, min=amin))


def band_table(fb: np.ndarray):
    """The kernel's band table of a filterbank fb [F, n_mels] f32, as int32
    words, and its group and pair counts.

    Each mel's band runs from its first to its last non-zero bin (by bit
    pattern, so a -0.0 inside counts too); zeros inside a band are kept, so
    the table gives ``fb`` back exactly. A mel with no non-zero bin has one
    pair flagged ``EMPTY`` (no term; its dB is that of ``amin``). The bands
    are flattened mel after mel into pairs (bin | flags, ``LAST`` on a
    band's last pair) with their weights; the mels are cut into groups of
    consecutive mels of at most ``GROUP_PAIRS`` pairs (a longer band alone).
    Words: the groups' first pairs [n_groups + 1], their first mels
    [n_groups], the pairs [n_pairs], the weights' bits [n_pairs]."""
    fb = np.ascontiguousarray(fb, np.float32)
    F, n_mels = fb.shape
    if F > BIN_MASK + 1:
        raise ValueError(f"stft_to_mel_db: {F} bins, at most {BIN_MASK + 1}")
    nonzero = fb.view(np.uint32) != 0
    pairs, weights = [], []
    for m in range(n_mels):
        bins = np.flatnonzero(nonzero[:, m])
        if bins.size:
            p = np.arange(bins[0], bins[-1] + 1, dtype=np.int64)
            w = fb[p, m]
        else:
            p, w = np.array([EMPTY], np.int64), np.zeros(1, np.float32)
        p[-1] |= LAST
        pairs.append(p)
        weights.append(w)
    pair0, mel0, n = [0], [0], 0
    for m, p in enumerate(pairs):
        if n and n + p.size > GROUP_PAIRS:
            pair0.append(pair0[-1] + n)
            mel0.append(m)
            n = 0
        n += p.size
    pair0.append(pair0[-1] + n)
    n_pairs = pair0[-1]
    words = np.concatenate([
        np.asarray(pair0, np.int64), np.asarray(mel0, np.int64),
        np.concatenate(pairs),
        np.concatenate(weights).view(np.int32).astype(np.int64)])
    return words.astype(np.int32), len(mel0), n_pairs


def table_groups(words: np.ndarray, n_groups: int, n_pairs: int):
    """The groups of a :func:`band_table`, as the kernel reads them: per
    group its first mel and its pairs' bins, flags and weights (f32)."""
    pair0 = words[:n_groups + 1]
    mel0 = words[n_groups + 1: 2 * n_groups + 1]
    pairs = words[2 * n_groups + 1: 2 * n_groups + 1 + n_pairs]
    weights = words[2 * n_groups + 1 + n_pairs:].view(np.float32)
    if weights.size != n_pairs or pair0[-1] != n_pairs:
        raise ValueError("table_groups: not a band table of "
                         f"{n_groups} groups and {n_pairs} pairs")
    for g in range(n_groups):
        k = slice(pair0[g], pair0[g + 1])
        yield int(mel0[g]), pairs[k] & BIN_MASK, pairs[k] & ~BIN_MASK, \
            weights[k]


def _device_table(fb: torch.Tensor):
    """fb's band table on its device, built at the first call for this
    filterbank (which reads ``fb`` to the host), then reused without a
    synchronization. Keyed by fb's storage, version, shape and device; the
    entry holds ``fb``, so its storage is not reused while cached. An
    inference tensor (``mel_filterbank`` called under
    ``torch.inference_mode``, as the serving entry points do) keeps no
    version, so an in-place change to one is not seen."""
    version = None if fb.is_inference() else fb._version
    key = (fb.data_ptr(), version, tuple(fb.shape), fb.device)
    hit = _TABLES.get(key)
    if hit is None:
        words, n_groups, n_pairs = band_table(fb.detach().cpu().numpy())
        table = torch.from_numpy(words).to(fb.device)
        hit = _TABLES[key] = (fb, table, n_groups, n_pairs)
        while len(_TABLES) > _MAX_TABLES:
            _TABLES.popitem(last=False)
    return hit[1:]


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
    if F2 != 2 * F:
        raise ValueError(f"stft_to_mel_db: stft has {F2} rows, "
                         f"fb has {F} frequencies")
    table, n_groups, n_pairs = _device_table(fb)
    out = torch.empty(B, n_mels, T, device=stft.device, dtype=torch.float32)
    kb.launch("mel_db", stft.device, kb.ptr(stft), kb.ptr(table), kb.ptr(out),
              B, F, T, n_mels, n_groups, n_pairs, amin)
    return out
