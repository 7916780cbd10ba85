"""M2D (Masked Modeling Duo, the reference's "mmd" arch) (PyTorch port of
``audiossl_tpu/compat/m2d.py``; reference ``downstream/comparison_models/
mmd_module.py`` over ``models/mmd_model.py`` + ``models/models_mae.py``).
The inference path (mmd_module.py:17-39 at mask_ratio 0, i.e.
models_mae.py:543-573 forward_encoder without masking):

  wav -> nnAudio MelSpectrogram (n_fft 400, hop 160, 80 Slaney mels,
  50-8000 Hz, power 2, center / reflect) -> ln(x + eps)
  -> (x - (-8.6463)) / 2.6721                    [DataTransform]
  -> zero-pad time to a multiple of 208 frames, split into 208-frame
     units -> each unit: the 16x16 patch embedding over [80, 208] (tokens
     FREQ-major: a 5 x 13 grid) -> + the position embedding -> CLS -> 12
     pre-LN ViT-base blocks -> LayerNorm -> drop CLS
     -> 'b (f t) d -> b t (f d)'  (embed 5 * 768 = 3840)
  -> the units along time, the padded tail and 1 more frame dropped (the
     reference's ``-(pad_emb_frames + 1)`` slice, mmd_module.py:37)

The trunk is :class:`audiossl_tpu_torch.compat.vit.TimmViT`; the mel is the
port's STFT (``ops.melspec.stft_conv``, full f32) and a Slaney filterbank.
"""
from __future__ import annotations

import dataclasses
import re
from pathlib import Path
from typing import Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn

from audiossl_tpu_torch.compat.vit import (TimmViT, ViTConfig,
                                           convert_timm_vit_state_dict,
                                           heads_for_dim, infer_depth,
                                           prefixed, unwrap)
from audiossl_tpu_torch.kernels.build import resolve_device
from audiossl_tpu_torch.ops.melspec import MelConfig, stft_conv

# reference mmd_module.DataTransform:106-109
M2D_NORM_STATS = (-8.6463, 2.6721)
M2D_MEL = MelConfig(n_fft=400, win_length=400, hop_length=160, n_mels=80,
                    f_min=50.0, f_max=8000.0, stft_precision="high")
M2D_UNIT_FRAMES = 208  # cfg.input_size[1] (mmd_model.py:24)


class M2DEncoder(nn.Module):
    """Normalized log-mels [B, 80, T] -> frame embeddings [B, T',
    n_freq_patches * embed_dim] (reference MMDModel.forward,
    mmd_module.py:17-39)."""

    def __init__(self, vit: ViTConfig = ViTConfig(max_patches=5 * 13),
                 unit_frames: int = M2D_UNIT_FRAMES, device=None):
        super().__init__()
        self.unit_frames = unit_frames
        self.vit = TimmViT(vit, device)

    @property
    def embed_dim(self):
        c = self.vit.cfg
        # the freq patches stacked a time step (80 mels / 16 = 5)
        ut = self.unit_frames // c.patch_size[1]
        return c.embed_dim * (c.max_patches // ut)

    def forward(self, lms: torch.Tensor) -> torch.Tensor:
        c = self.vit.cfg
        U = self.unit_frames
        B, Fq, T = lms.shape
        nf = Fq // c.patch_size[0]  # freq patches (5)
        pad = (-T) % U
        if pad:
            lms = nn.functional.pad(lms, (0, pad))
        n_units = (T + pad) // U
        # the units folded into the batch: one forward
        x = lms.reshape(B, Fq, n_units, U).permute(0, 2, 1, 3).reshape(
            B * n_units, Fq, U)
        toks = self.vit(x)[:, c.num_prefix:]  # drop CLS
        ut = U // c.patch_size[1]  # time steps a unit (13)
        D = c.embed_dim
        # freq-major tokens (f * ut + t) -> [.., t, f * D]
        toks = toks.reshape(B, n_units, nf, ut, D).permute(0, 1, 3, 2, 4)
        toks = toks.reshape(B, n_units * ut, nf * D)
        if pad:
            # the reference drops int(ut * pad / U) padded frames and one
            # more (mmd_module.py:34-37)
            toks = toks[:, :-(int(ut * pad / U) + 1)]
        return toks


def _slaney_fb(cfg: MelConfig, device) -> torch.Tensor:
    from audiossl_tpu_torch.compat.byola import _slaney_filterbank

    return torch.from_numpy(_slaney_filterbank(cfg)).to(device)


def m2d_logmel(wav: torch.Tensor, stats=M2D_NORM_STATS) -> torch.Tensor:
    """[B, L] waveforms -> normalized log-mels [B, 80, T] (reference
    mmd_module.DataTransform: nnAudio's Slaney mel, natural log, fixed
    statistics)."""
    stft = stft_conv(wav, M2D_MEL)  # [B, 2F, T]
    Fr = M2D_MEL.n_freqs
    power = stft[:, :Fr] ** 2 + stft[:, Fr:] ** 2
    mel = torch.einsum("bft,mf->bmt", power, _slaney_fb(M2D_MEL, wav.device))
    eps = float(np.finfo(np.float32).eps)
    mean, std = stats
    return (torch.log(mel + eps) - mean) / (std + eps)


def convert_m2d_checkpoint(sd: Mapping) -> Dict[str, torch.Tensor]:
    """The authors' M2D ``checkpoint['model']`` -> :class:`M2DEncoder`'s
    state dict: the encoder trunk (timm naming); the target, decoder and
    mask-token weights are left out, as the reference's encoder use
    leaves them."""
    return prefixed(convert_timm_vit_state_dict(sd, depth=infer_depth(sd)),
                    "vit.")


def m2d_from_state_dict(sd: Mapping, input_size=(80, 208),
                        patch_size=(16, 16), device="cuda") -> M2DEncoder:
    """The authors' state dict -> :class:`M2DEncoder` on ``device``, in
    eval mode."""
    port = convert_m2d_checkpoint(sd)
    D = port["vit.pos_embed"].shape[-1]
    gh, gw = (input_size[0] // patch_size[0], input_size[1] // patch_size[1])
    enc = M2DEncoder(
        ViTConfig(embed_dim=D, depth=infer_depth(sd),
                  num_heads=heads_for_dim(D), patch_size=tuple(patch_size),
                  max_patches=gh * gw),
        unit_frames=input_size[1], device=resolve_device(device))
    enc.load_state_dict(port)
    return enc.eval()


def load_m2d_checkpoint(path: str, input_size=(80, 208), patch_size=(16, 16),
                        device="cuda") -> M2DEncoder:
    """A released M2D ``.pth`` (a trusted third-party file, read with
    ``weights_only=False`` as the JAX loader reads it) ->
    :class:`M2DEncoder`. The reference parses the input and patch sizes
    from the checkpoint's folder name (``m2d_vit_base-80x208p16x16-...``,
    mmd_model.py:41-47); they are arguments here with the same defaults,
    and the folder name is parsed too."""
    m = re.match(r".*-(\d+)x(\d+)p(\d+)x(\d+)", Path(path).parent.name)
    if m:
        input_size = (int(m.group(1)), int(m.group(2)))
        patch_size = (int(m.group(3)), int(m.group(4)))
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    return m2d_from_state_dict(unwrap(ckpt, "model"), input_size,
                               patch_size, device)


@dataclasses.dataclass
class M2DAdapter:
    """M2D as a frame encoder of the SED drivers (reference mmd_module.py):
    the 100 fps mel pooled by the 16-frame patch -> 6.25 fps frames of dim
    3840."""
    encoder: M2DEncoder

    @property
    def embed_dim(self):
        return self.encoder.embed_dim

    @property
    def frame_rate_divisor(self):
        return 16

    def token_count(self, n_samples: int) -> int:
        T = 1 + n_samples // 160  # centred framing
        U = self.encoder.unit_frames
        ut = U // self.encoder.vit.cfg.patch_size[1]
        pad = (-T) % U
        n = (T + pad) // U * ut
        return n - (int(ut * pad / U) + 1) if pad else n

    def frame_embeddings(self, wav, valid,
                         dps: Optional[torch.Tensor] = None):
        """-> [B, T', D]; ``valid`` and ``dps`` are not read."""
        with torch.no_grad():
            lms = m2d_logmel(wav)
        return self.encoder(lms)
