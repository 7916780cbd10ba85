"""SSAST encoder family, frame and patch variants (PyTorch port of
``audiossl_tpu/compat/ssast.py``; reference ``downstream/
comparison_models/{ssast,patch_ssast}_module.py`` over ``models/
ssast.py``). The inference path (ssast_module.py:26-48,
patch_ssast_module.py:22-45):

  wav - mean(wav) -> Kaldi fbank (128 mels, hanning, 10 ms shift)
  -> (fbank - norm_mean) / (2 * norm_std)     [AudioMAE's statistics]
  -> [B, 128 (freq), T] patch embedding, kernel = stride = (128, 2) for
     the frame variant, (16, 16) for the patch one (tokens freq-major)
  -> CLS + DIST prefix (the DeiT-distilled backbone) + position embedding
  -> 12 pre-LN ViT blocks -> LayerNorm -> drop the prefix
  -> the modules' exact AvgPool quirks:
     frame: AvgPool2d((2, 1), padding=(1, 0)) over tokens: row 0 is HALF
       of token 0 (the zero pad counts in the mean), row i > 0 the mean
       of tokens 2i-1 and 2i                     (ssast_module.py:24, 47)
     patch: [B, 8, T', D], AvgPool2d([8, 1], padding=[1, 0]): ONE row,
       sum(freq rows 0..6) / 8 (row 7 never enters the window; the zero
       pad row does)                     (patch_ssast_module.py:20, 40-44)

The importer rebuilds the position embedding from the pretraining grid to
the finetuning one as ``ASTModel.__init__`` does (ssast.py:190-202): a
centre cut along time where the finetuning grid is narrower (the released
checkpoints: 1024 pretraining frames, 998 for DCASE).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Tuple

import torch
from torch import nn

from audiossl_tpu_torch.compat.audiomae import audiomae_fbank, snip_frames
from audiossl_tpu_torch.compat.vit import (TimmViT, ViTConfig,
                                           convert_timm_vit_state_dict,
                                           heads_for_dim, infer_depth,
                                           prefixed, unwrap)
from audiossl_tpu_torch.kernels.build import resolve_device

# reference ssast_module.py:14-19: AudioMAE's statistics
ssast_fbank = audiomae_fbank


class SSASTEncoder(nn.Module):
    """Normalized fbank [B, T, 128] -> frame embeddings.

    ``variant='frame'``: patch (128, 2) -> [B, N//2 + 1, D], N = T//2
    ``variant='patch'``: patch (16, 16) -> [B, T//16, D]
    """

    def __init__(self, vit: ViTConfig = ViTConfig(
            patch_size=(128, 2), num_prefix=2, max_patches=499),
            variant: str = "frame", device=None):
        super().__init__()
        self.variant = variant
        self.vit = TimmViT(vit, device)

    @property
    def embed_dim(self):
        return self.vit.cfg.embed_dim

    def forward(self, fbank: torch.Tensor) -> torch.Tensor:
        x = fbank.transpose(1, 2)  # [B, 128, T]: freq as H
        toks = self.vit(x)[:, self.vit.cfg.num_prefix:]
        B, N, D = toks.shape
        if self.variant == "frame":
            # AvgPool2d((2, 1), padding=(1, 0)): a zero row above and below
            # (count_include_pad), stride-2 pairs -> N//2 + 1 rows
            n_out = N // 2 + 1
            toks = nn.functional.pad(toks, (0, 0, 1, 2 * n_out - (N + 1)))
            return toks.reshape(B, n_out, 2, D).mean(dim=2)
        # patch: tokens freq-major [8, T']; AvgPool2d([8, 1], pad [1, 0])
        # emits one row over (zero pad + freq rows 0..6) / 8
        toks = toks.reshape(B, 8, N // 8, D)
        return toks[:, :7].sum(dim=1) / 8.0


def convert_ssast_checkpoint(sd: Mapping, fshape: int = 128, tshape: int = 2,
                             input_fdim: int = 128, input_tdim: int = 998
                             ) -> Tuple[Dict[str, torch.Tensor], ViTConfig]:
    """The reference's SSL pretraining checkpoint (DataParallel
    ``module.v.*`` keys, ssast.py:141-157) -> (:class:`SSASTEncoder`'s
    state dict, its ViTConfig).

    The finetuning rebuild of the position embedding (ssast.py:190-202):
    the prefix rows split off, the rest as the pretraining (p_f_dim,
    p_t_dim) grid, centre-cut to the finetuning grid (the interpolating
    branch for a grid wider than the pretraining one lies outside the
    released checkpoints and raises)."""
    sd = {k[len("module."):] if k.startswith("module.") else k: v
          for k, v in sd.items()}

    def item(key):
        t = sd[key]
        return int(t.item() if hasattr(t, "item") else t)

    p_f_dim = (item("p_input_fdim") - fshape) // fshape + 1
    p_t_dim = (item("p_input_tdim") - tshape) // tshape + 1
    f_dim = (input_fdim - fshape) // fshape + 1
    t_dim = (input_tdim - tshape) // tshape + 1
    if f_dim > p_f_dim or t_dim > p_t_dim:
        raise NotImplementedError(
            "a finetuning grid larger than the pretraining grid needs the "
            "bilinear-interpolation branch (ssast.py:195)")
    dist = "v.dist_token" in sd
    n_prefix = 2 if dist else 1
    depth = infer_depth(sd, prefix="v.")
    port = convert_timm_vit_state_dict(sd, depth=depth, prefix="v.",
                                       dist_token=dist)
    pos = port["pos_embed"]  # [prefix + p_f * p_t, D]
    D = pos.shape[-1]
    grid = pos[n_prefix:].reshape(p_f_dim, p_t_dim, D)
    t0 = p_t_dim // 2 - t_dim // 2
    f0 = p_f_dim // 2 - f_dim // 2
    grid = grid[f0: f0 + f_dim, t0: t0 + t_dim]
    port["pos_embed"] = torch.cat(
        [pos[:n_prefix], grid.reshape(f_dim * t_dim, D)], dim=0)
    cfg = ViTConfig(embed_dim=D, depth=depth, num_heads=heads_for_dim(D),
                    patch_size=(fshape, tshape), num_prefix=n_prefix,
                    max_patches=f_dim * t_dim,
                    # SSAST grids are freq-major (f_dim rows of t_dim time
                    # columns): an input shorter than input_tdim slices the
                    # position embedding by column
                    pos_grid=(f_dim, t_dim))
    return prefixed(port, "vit."), cfg


def ssast_from_state_dict(sd: Mapping, variant: str = "frame",
                          input_tdim: int = 998,
                          device="cuda") -> SSASTEncoder:
    """The reference's state dict -> :class:`SSASTEncoder` on ``device``,
    in eval mode. ``variant`` picks the frame (128x2) or the patch (16x16)
    shapes, as the two reference modules hard-code them
    (ssast_module.py:53-55, patch_ssast_module.py:50-52)."""
    fshape, tshape = (128, 2) if variant == "frame" else (16, 16)
    port, cfg = convert_ssast_checkpoint(sd, fshape=fshape, tshape=tshape,
                                         input_tdim=input_tdim)
    enc = SSASTEncoder(cfg, variant=variant, device=resolve_device(device))
    enc.load_state_dict(port)
    return enc.eval()


def load_ssast_checkpoint(path: str, variant: str = "frame",
                          input_tdim: int = 998,
                          device="cuda") -> SSASTEncoder:
    """A released SSAST SSL checkpoint (a trusted third-party file, read
    with ``weights_only=False`` as the JAX loader reads it) ->
    :class:`SSASTEncoder`."""
    sd = torch.load(path, map_location="cpu", weights_only=False)
    return ssast_from_state_dict(unwrap(sd, "model"), variant, input_tdim,
                                 device)


@dataclasses.dataclass
class SSASTAdapter:
    """SSAST as a frame encoder of the SED drivers: the 100 fps fbank ->
    25 fps (frame variant, 768-d) or 6.25 fps (patch variant)."""
    encoder: SSASTEncoder

    @property
    def embed_dim(self):
        return self.encoder.embed_dim

    @property
    def frame_rate_divisor(self):
        return 4 if self.encoder.variant == "frame" else 16

    def token_count(self, n_samples: int) -> int:
        frames = snip_frames(n_samples)
        if self.encoder.variant == "frame":
            # the (128, 2) stride-2 patches -> N tokens, then
            # AvgPool2d((2, 1), padding=(1, 0)) -> N//2 + 1 rows
            n = (frames - 2) // 2 + 1
            return n // 2 + 1
        return (frames - 16) // 16 + 1

    def frame_embeddings(self, wav, valid,
                         dps: Optional[torch.Tensor] = None):
        """-> [B, T', D]; ``valid`` and ``dps`` are not read."""
        with torch.no_grad():
            fb = ssast_fbank(wav)
        return self.encoder(fb)
