"""Waveforms and labels of a run, made on the device from ``--seed``.

A clip is noise at a level drawn per clip (-40 to -10 dBFS) under three
tones of random pitch (100 Hz to 4 kHz) and level, so that its mel has
structure across bands and frames; every clip fills its 10 s.
"""
from __future__ import annotations

import math

import torch


def clips(gen: torch.Generator, batch: int, samples: int, device,
          sr: int = 16000) -> torch.Tensor:
    """f32 waveforms [batch, samples] in [-1, 1)."""
    def rand(*shape):
        return torch.rand(*shape, generator=gen, device=device)

    noise_db = -40.0 + 30.0 * rand(batch, 1)
    wav = torch.randn(batch, samples, generator=gen, device=device) \
        * torch.pow(10.0, noise_db / 20.0)
    t = torch.arange(samples, device=device, dtype=torch.float32) / sr
    freq = 100.0 * torch.pow(40.0, rand(batch, 3))
    amp = 0.2 * rand(batch, 3)
    phase = 2 * math.pi * rand(batch, 3)
    for k in range(3):
        wav = wav + amp[:, k:k + 1] * torch.sin(
            2 * math.pi * freq[:, k:k + 1] * t[None, :] + phase[:, k:k + 1])
    return torch.clamp(wav, -1.0, 1.0 - 2.0 ** -15)


def to_int16(wav: torch.Tensor) -> torch.Tensor:
    """The int16 samples of a pack (x * 32768, rounded)."""
    return torch.round(wav * 32768.0).clamp(-32768, 32767).to(torch.int16)


def multi_hot(gen: torch.Generator, batch: int, labels: int, device,
              per_clip: int = 3) -> torch.Tensor:
    """[batch, labels] f32 with 1 to ``per_clip`` labels set per clip."""
    n = 1 + torch.randint(0, per_clip, (batch,), generator=gen, device=device)
    idx = torch.randint(0, labels, (batch, per_clip), generator=gen,
                        device=device)
    on = torch.arange(per_clip, device=device)[None, :] < n[:, None]
    y = torch.zeros(batch, labels, device=device)
    y.scatter_reduce_(1, idx, on.float(), reduce="amax")
    return y
