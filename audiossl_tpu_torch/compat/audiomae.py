"""AudioMAE encoder family (PyTorch port of ``audiossl_tpu/compat/
audiomae.py``; reference ``downstream/comparison_models/
audioMAE_module.py`` over Meta's ``models/audioMAE_model.py``). The
inference path (audioMAE_module.py:44-92):

  wav - mean(wav) -> Kaldi fbank (128 mels, hanning, 10 ms shift)
  -> (fbank - norm_mean) / (2 * norm_std)
  -> 16x16 patch embedding over [T, 128] (tokens time-major, 8 freq
     patches a 16-frame step)
  -> + the position embedding (its leading rows for short inputs)
  -> CLS + pos[0] -> 12 pre-LN ViT-base blocks -> LayerNorm -> drop CLS
  -> AvgPool1d(8, 8) over tokens: the mean of each step's 8 freq patches
  -> frame embeddings [B, T//16, 768]

The trunk is :class:`audiossl_tpu_torch.compat.vit.TimmViT`.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional

import torch
from torch import nn

from audiossl_tpu_torch.compat.vit import (TimmViT, ViTConfig,
                                           convert_timm_vit_state_dict,
                                           heads_for_dim, infer_depth,
                                           prefixed, unwrap)
from audiossl_tpu_torch.kernels.build import resolve_device

# reference audioMAE_module.py:13-18
AUDIOMAE_NORM_MEAN = -6.030435443767988
AUDIOMAE_NORM_STD = 4.102992546322562
# the reference's patch grid: img_size (1024, 128) / 16 -> 64 * 8 = 512
AUDIOMAE_MAX_PATCHES = 512


class AudioMAEEncoder(nn.Module):
    """Normalized fbank [B, T, 128] -> frame embeddings [B, T//16, D]
    (reference AudioMAEModel.forward, audioMAE_module.py:44-62)."""

    def __init__(self, vit: ViTConfig = ViTConfig(
            max_patches=AUDIOMAE_MAX_PATCHES), device=None):
        super().__init__()
        self.vit = TimmViT(vit, device)

    @property
    def embed_dim(self):
        return self.vit.cfg.embed_dim

    def forward(self, fbank: torch.Tensor) -> torch.Tensor:
        cfg = self.vit.cfg
        B, T, Fq = fbank.shape
        # the norm is per token, so norming then dropping CLS is dropping
        # then norming
        toks = self.vit(fbank)[:, cfg.num_prefix:]
        nf = Fq // cfg.patch_size[1]  # freq patches a time step (8)
        _, N, D = toks.shape
        return toks.reshape(B, N // nf, nf, D).mean(dim=2)


def audiomae_fbank(wav: torch.Tensor) -> torch.Tensor:
    """[B, L] waveforms -> normalized fbank [B, T, 128] (reference
    AudioMAEPredModule.transform, audioMAE_module.py:76-92: each clip's
    mean removed, the Kaldi hanning fbank, fixed statistics)."""
    from audiossl_tpu_torch.compat.beats import kaldi_fbank

    wav = wav.float()
    wav = wav - wav.mean(dim=-1, keepdim=True)
    fb = kaldi_fbank(wav, num_mel_bins=128, window_type="hanning")
    return (fb - AUDIOMAE_NORM_MEAN) / (AUDIOMAE_NORM_STD * 2.0)


def convert_audiomae_checkpoint(sd: Mapping) -> Dict[str, torch.Tensor]:
    """The authors' ``checkpoint['model']`` (timm ViT naming) ->
    :class:`AudioMAEEncoder`'s state dict. The reference drops the
    classifier head and loads the rest ``strict=False``
    (audioMAE_module.py:36-41); only the trunk is read here."""
    return prefixed(convert_timm_vit_state_dict(sd, depth=infer_depth(sd)),
                    "vit.")


def audiomae_from_state_dict(sd: Mapping, device="cuda") -> AudioMAEEncoder:
    """The authors' state dict -> :class:`AudioMAEEncoder` on ``device``
    (sized by its shapes), in eval mode."""
    port = convert_audiomae_checkpoint(sd)
    n_pos, D = port["vit.pos_embed"].shape
    enc = AudioMAEEncoder(
        ViTConfig(embed_dim=D, depth=infer_depth(sd),
                  num_heads=heads_for_dim(D), max_patches=n_pos - 1),
        device=resolve_device(device))
    enc.load_state_dict(port)
    return enc.eval()


def load_audiomae_checkpoint(path: str, device="cuda") -> AudioMAEEncoder:
    """A released AudioMAE ``.pth`` (a trusted third-party file, read with
    ``weights_only=False`` as the JAX loader reads it) ->
    :class:`AudioMAEEncoder`."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    return audiomae_from_state_dict(unwrap(ckpt, "model"), device)


def snip_frames(n_samples: int) -> int:
    """Kaldi fbank frames of ``n_samples`` (snip_edges, 25 ms / 10 ms)."""
    return 1 + (n_samples - 400) // 160


@dataclasses.dataclass
class AudioMAEAdapter:
    """AudioMAE as a frame encoder of the SED drivers (reference
    audioMAE_module.py): the 100 fps fbank pooled by the 16-frame patch
    -> 6.25 fps frame embeddings of dim 768."""
    encoder: AudioMAEEncoder

    @property
    def embed_dim(self):
        return self.encoder.embed_dim

    @property
    def frame_rate_divisor(self):
        return 16  # fbank frames an output frame (patch_t)

    def token_count(self, n_samples: int) -> int:
        return snip_frames(n_samples) // 16

    def frame_embeddings(self, wav, valid,
                         dps: Optional[torch.Tensor] = None):
        """-> [B, T', D]; ``valid`` and ``dps`` are not read (the
        reference's transform takes the padded clip whole; no drop
        path)."""
        with torch.no_grad():
            fb = audiomae_fbank(wav)
        return self.encoder(fb)
