"""BYOL-A encoder family (PyTorch port of ``audiossl_tpu/compat/byola.py``;
reference ``downstream/comparison_models/byola_module.py:12-44`` and
``models/byola.py:60-110``):

* :class:`AudioNTT2022Encoder` — conv(3x3) + BN + ReLU + maxpool(2),
  twice, over [B, 1, mels, T] log-mels, the (channel x mel/4) features of
  each time step flattened, a 2048-hidden MLP, and the "stack" concat of
  the conv features with the MLP's -> [B, T/4, 3072];
* :func:`convert_byola_state_dict` — the authors' ``state_dict`` -> the
  port's (:func:`load_byola_checkpoint` unwraps ``state_dict`` / ``model``
  and ``model.`` prefixes, as the reference's load_pretrained_weights
  does);
* :func:`byola_logmel` — the nnAudio front end: the power mel of a
  **Slaney** (librosa's default) filterbank over the port's STFT on the
  1024 / 160 / 64 grid of the repository's mel, natural log, and the
  reference's PrecomputedNorm statistics (byola_module.py:72-73).

The BatchNorms run on the checkpoint's running statistics always, in
training mode too: JAX applies the CNN with fixed ``batch_stats`` that it
never makes mutable (``downstream/comparison_models.py:180-184``), so SED
finetuning trains their scale and bias and never their statistics (the
reference updates them; a documented departure of both packages).
"""
from __future__ import annotations

import functools
from typing import Dict, Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from audiossl_tpu_torch.compat.vit import f32
from audiossl_tpu_torch.kernels.build import resolve_device
from audiossl_tpu_torch.ops.melspec import MelConfig, stft_conv

BYOLA_NORM_STATS = (-6.596029, 3.5494373)  # byola_module.py:72


class RunningStatsBatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` (the same names and state dict) that normalizes
    with its running statistics in either mode and never updates them."""

    def forward(self, x):
        return F.batch_norm(x, self.running_mean, self.running_var,
                            self.weight, self.bias, False, 0.0, self.eps)


class AudioNTT2022Encoder(nn.Module):
    """reference models/byola.py:60-95 (the stack=True variant)."""

    def __init__(self, n_mels: int = 64, d: int = 3072, base_d: int = 64,
                 mlp_hidden_d: int = 2048, conv_layers: int = 2,
                 device=None):
        super().__init__()
        self.n_mels, self.d = n_mels, d
        convs, bns = [], []
        for i in range(conv_layers):
            convs.append(nn.Conv2d(1 if i == 0 else base_d, base_d, 3,
                                   padding=1, device=device))
            bns.append(RunningStatsBatchNorm2d(base_d, eps=1e-5,
                                               device=device))
        self.convs, self.bns = nn.ModuleList(convs), nn.ModuleList(bns)
        feat = base_d * (n_mels // 2 ** conv_layers)
        self.fc0 = nn.Linear(feat, mlp_hidden_d, device=device)
        self.fc1 = nn.Linear(mlp_hidden_d, d - feat, device=device)

    def forward(self, lms: torch.Tensor) -> torch.Tensor:
        """lms [B, mels, T], normalized log-mels -> [B, T//4, d]."""
        x = lms.float()[:, None]  # [B, 1, mels, T]
        for conv, bn in zip(self.convs, self.bns):
            x = F.max_pool2d(F.relu(bn(conv(x))), 2)
        # (B, ch, mel, time) -> (B, time, mel * ch), mel-major (m * C + c)
        B, C, M, T = x.shape
        x = x.permute(0, 3, 2, 1).reshape(B, T, M * C)
        h = F.relu(self.fc1(F.relu(self.fc0(x))))
        return torch.cat([x, h], dim=-1)  # stack=True


@functools.lru_cache(maxsize=8)
def _slaney_filterbank(cfg: MelConfig) -> np.ndarray:
    """librosa.filters.mel's defaults (htk=False, norm='slaney') ->
    [n_mels, n_freqs] f32."""
    f_sp = 200.0 / 3
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0

    def hz_to_mel(f):
        f = np.asarray(f, np.float64)
        return np.where(f >= min_log_hz,
                        min_log_mel + np.log(f / min_log_hz) / logstep,
                        f / f_sp)

    def mel_to_hz(m):
        m = np.asarray(m, np.float64)
        return np.where(m >= min_log_mel,
                        min_log_hz * np.exp(logstep * (m - min_log_mel)),
                        f_sp * m)

    fft_freqs = np.arange(cfg.n_freqs) * (cfg.sample_rate / cfg.n_fft)
    hz = mel_to_hz(np.linspace(hz_to_mel(cfg.f_min), hz_to_mel(cfg.f_max),
                               cfg.n_mels + 2))
    fdiff = np.diff(hz)
    ramps = hz[:, None] - fft_freqs[None, :]
    fb = np.zeros((cfg.n_mels, cfg.n_freqs), np.float64)
    for i in range(cfg.n_mels):
        lower = -ramps[i] / fdiff[i]
        upper = ramps[i + 2] / fdiff[i + 1]
        fb[i] = np.maximum(0, np.minimum(lower, upper))
    fb *= (2.0 / (hz[2:cfg.n_mels + 2] - hz[:cfg.n_mels]))[:, None]
    return fb.astype(np.float32)


def byola_logmel(wav: torch.Tensor,
                 cfg: MelConfig = MelConfig(stft_precision="high"),
                 stats=BYOLA_NORM_STATS) -> torch.Tensor:
    """[B, L] waveforms -> normalized log-mels [B, mels, T] (nnAudio's
    MelSpectrogram, power 2, with librosa's Slaney filterbank, then ln
    and PrecomputedNorm; byola_module.DataTransform)."""
    stft = stft_conv(wav, cfg)  # [B, 2F, T]
    Fr = cfg.n_freqs
    power = stft[:, :Fr] ** 2 + stft[:, Fr:] ** 2
    fb = torch.from_numpy(_slaney_filterbank(cfg)).to(wav.device)
    mel = torch.einsum("bft,mf->bmt", power, fb)
    eps = float(np.finfo(np.float32).eps)
    mean, std = stats
    return (torch.log(mel + eps) - mean) / std


def convert_byola_state_dict(sd: Mapping) -> Dict[str, torch.Tensor]:
    """The authors' AudioNTT2022Encoder ``state_dict`` ->
    :class:`AudioNTT2022Encoder`'s. Sequential indices: features.{0,4}
    convs, features.{1,5} BatchNorms, fc.{0,3} Linears (models/byola.py:
    63-88)."""
    out = {}
    for i, (ci, bi) in enumerate(((0, 1), (4, 5))):
        for p in ("weight", "bias"):
            out[f"convs.{i}.{p}"] = f32(sd[f"features.{ci}.{p}"])
        for p in ("weight", "bias", "running_mean", "running_var"):
            out[f"bns.{i}.{p}"] = f32(sd[f"features.{bi}.{p}"])
        n = sd.get(f"features.{bi}.num_batches_tracked")
        out[f"bns.{i}.num_batches_tracked"] = torch.as_tensor(
            0 if n is None else n, dtype=torch.long).clone()
    for j, fi in ((0, 0), (1, 3)):
        for p in ("weight", "bias"):
            out[f"fc{j}.{p}"] = f32(sd[f"fc.{fi}.{p}"])
    return out


def byola_from_state_dict(sd: Mapping, n_mels: int = 64, d: int = 3072,
                          device="cuda") -> AudioNTT2022Encoder:
    """The authors' state dict -> :class:`AudioNTT2022Encoder` on
    ``device``, in eval mode."""
    enc = AudioNTT2022Encoder(n_mels=n_mels, d=d,
                              device=resolve_device(device))
    enc.load_state_dict(convert_byola_state_dict(sd))
    return enc.eval()


def load_byola_checkpoint(path: str, n_mels: int = 64, d: int = 3072,
                          device="cuda") -> AudioNTT2022Encoder:
    """A released BYOL-A ``.pth`` (a trusted third-party file, read with
    ``weights_only=False`` as the JAX loader reads it) ->
    :class:`AudioNTT2022Encoder`. Unwraps ``state_dict`` and ``model`` and
    strips ``model.`` prefixes, as the reference's load_pretrained_weights
    does (models/byola.py:15-49)."""
    sd = torch.load(path, map_location="cpu", weights_only=False)
    if "state_dict" in sd:
        sd = sd["state_dict"]
    if "model" in sd:
        sd = sd["model"]
    sd = {k.split("model.", 1)[-1] if k.startswith("model.") else k: v
          for k, v in sd.items()}
    return byola_from_state_dict(sd, n_mels, d, device)
