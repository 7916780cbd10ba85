"""MAE-AST encoder family, frame and patch variants (PyTorch port of
``audiossl_tpu/compat/maeast.py``; reference ``downstream/
comparison_models/{mae_ast,mae_ast_patch}_module.py`` over the
fairseq-based ``models/mae_ast.py`` / ``mae_ast_patch.py``). The inference
path (mae_ast_module.py:25-36, mae_ast.py:358-435 with ``mask=False,
features_only=True``):

  wav -> Kaldi fbank (128 mels, povey window, 10 ms shift, NO
     normalization: mae_ast_module.py:54-64)
  -> BatchNorm2d(1, affine=False) over the whole [B, 1, T, 128] "image" on
     its running statistics, times 0.5 (mae_ast.py:373-375)
  -> Unfold, kernel = stride: (time 2, freq 128) frame variant, (16, 16)
     patch variant -> 256-d patches, tokens time-major (mae_ast.py:210-211,
     378)
  -> Linear 256 -> 768 (post_extract_proj)
  -> + the interleaved sin/cos encoding of the token index
     (SinusoidalPositionalEncoding, mae_ast.py:779-797)
  -> ONE LayerNorm before the stack (fairseq's TransformerEncoder with
     ``layer_norm_first=False``, mae_ast.py:638-640)
  -> 12 POST-LN layers: attention -> + residual -> LN -> FFN (erf GELU)
     -> + residual -> LN (TransformerSentenceEncoderLayer,
     mae_ast.py:755-774); no final norm
  -> pooling: frame: the last token repeated, then the mean of token
     pairs (AvgPool2d((2, 1)), mae_ast_module.py:34-35) -> 25 fps; patch:
     the mean of each step's 8 freq patches (mae_ast_patch_module.py:
     33-35) -> 6.25 fps

fairseq's separate q, k and v projections are packed into one qkv Linear
by the importer (q scaled by head_dim**-0.5 before the product there, the
scores here: the same function), and the attention is the port's
``Attention(fused_attention=True)``, as JAX's is: the standalone MHA
kernel K6 (``ops/mha.py``) on the card, forward and, when SED finetunes,
backward, with an all-zero mask (every key valid). Its norms are plain
``nn.LayerNorm``, not ``LayerNormPG``, so K8 does not run. The
BatchNorm's running mean and variance are parameters (JAX's
``self.param``), so SED finetuning trains them, as JAX's does.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from audiossl_tpu_torch.compat.audiomae import snip_frames
from audiossl_tpu_torch.compat.vit import (extract_patches, f32,
                                           heads_for_dim, unwrap)
from audiossl_tpu_torch.kernels.build import resolve_device
from audiossl_tpu_torch.models.transformer import Attention, Mlp


def interleaved_sincos_pe(n: int, d: int) -> np.ndarray:
    """The transformer encoding [n, d]: even dims sin, odd dims cos
    (reference SinusoidalPositionalEncoding, mae_ast.py:781-788)."""
    position = np.arange(n, dtype=np.float64)[:, None]
    div = np.exp(np.arange(0, d, 2, dtype=np.float64)
                 * (-np.log(10000.0) / d))
    pe = np.zeros((n, d), np.float32)
    pe[:, 0::2] = np.sin(position * div)
    pe[:, 1::2] = np.cos(position * div)
    return pe


@dataclasses.dataclass(frozen=True)
class MAEASTConfig:
    embed_dim: int = 768
    depth: int = 12
    num_heads: int = 12
    ffn_dim: int = 3072
    kernel: Tuple[int, int] = (2, 128)  # (time, freq); patch: (16, 16)
    variant: str = "frame"
    ln_eps: float = 1e-5  # fairseq LayerNorm and BatchNorm2d eps


class PostLNLayer(nn.Module):
    """fairseq TransformerSentenceEncoderLayer, layer_norm_first=False
    (mae_ast.py:755-774); the attention through K6 on the card."""

    def __init__(self, dim: int, num_heads: int, ffn_dim: int,
                 eps: float = 1e-5, device=None):
        super().__init__()
        self.attn = Attention(dim, num_heads, qkv_bias=True, device=device,
                              fused_attention=True)
        self.norm1 = nn.LayerNorm(dim, eps=eps, device=device)
        self.mlp = Mlp(dim, ffn_dim, device=device)
        self.norm2 = nn.LayerNorm(dim, eps=eps, device=device)

    def forward(self, x):
        x = self.norm1(x + self.attn(x))
        return self.norm2(x + self.mlp(x))


class MAEASTEncoder(nn.Module):
    """Raw Kaldi fbank [B, T, 128] -> frame embeddings [B, (T//2 + 1)//2,
    D] (frame variant) or [B, T//16, D] (patch)."""

    def __init__(self, cfg: MAEASTConfig = MAEASTConfig(), device=None):
        super().__init__()
        self.cfg = cfg
        kt, kf = cfg.kernel
        # BatchNorm2d(1, affine=False)'s running statistics, trained as
        # JAX's params are
        self.bn_mean = nn.Parameter(torch.zeros(1, device=device))
        self.bn_var = nn.Parameter(torch.ones(1, device=device))
        self.patch_proj = nn.Linear(kt * kf, cfg.embed_dim, device=device)
        self.enc_norm = nn.LayerNorm(cfg.embed_dim, eps=cfg.ln_eps,
                                     device=device)
        self.layers = nn.ModuleList(
            PostLNLayer(cfg.embed_dim, cfg.num_heads, cfg.ffn_dim,
                        cfg.ln_eps, device) for _ in range(cfg.depth))

    @property
    def embed_dim(self):
        return self.cfg.embed_dim

    def forward(self, fbank: torch.Tensor) -> torch.Tensor:
        c = self.cfg
        x = (fbank.float() - self.bn_mean[0]) * torch.rsqrt(
            self.bn_var[0] + 1e-5) * 0.5
        tok = self.patch_proj(extract_patches(x, *c.kernel))
        B, N, D = tok.shape
        pe = torch.from_numpy(interleaved_sincos_pe(N, D)).to(tok.device)
        tok = self.enc_norm(tok + pe)
        for layer in self.layers:
            tok = layer(tok)
        if c.variant == "frame":
            tok = torch.cat([tok, tok[:, -1:]], dim=1)
            n_out = (N + 1) // 2
            return tok[:, : 2 * n_out].reshape(B, n_out, 2, D).mean(dim=2)
        nf = 128 // c.kernel[1]  # freq patches a time step (8)
        return tok.reshape(B, N // nf, nf, D).mean(dim=2)


# --------------------------- torch importer --------------------------- #

def convert_maeast_checkpoint(sd: Mapping) -> Dict[str, torch.Tensor]:
    """The authors' ``checkpoint['model']`` (raw MAE_AST naming, which
    mae_ast_module.py:43-46 loads strict) -> :class:`MAEASTEncoder`'s
    state dict.

    Read: the BatchNorm's running statistics, post_extract_proj, the
    encoder's pre-stack layer_norm, and encoder.layers.N.* with q, k and v
    packed into qkv. Left out, as the reference's features-only path
    leaves them: decoder.*, final_proj_*, *_mask_emb, the unused
    model-level 128-d layer_norm and the sinusoidal buffers (recomputed)."""
    out = {"bn_mean": f32(sd["batch_norm.running_mean"]).reshape(1),
           "bn_var": f32(sd["batch_norm.running_var"]).reshape(1),
           "patch_proj.weight": f32(sd["post_extract_proj.weight"]),
           "patch_proj.bias": f32(sd["post_extract_proj.bias"]),
           "enc_norm.weight": f32(sd["encoder.layer_norm.weight"]),
           "enc_norm.bias": f32(sd["encoder.layer_norm.bias"])}
    depth = 1 + max(int(k.split(".")[2]) for k in sd
                    if k.startswith("encoder.layers."))
    names = {"attn.proj": "self_attn.out_proj",
             "norm1": "self_attn_layer_norm", "mlp.fc1": "fc1",
             "mlp.fc2": "fc2", "norm2": "final_layer_norm"}
    for i in range(depth):
        b = f"encoder.layers.{i}."
        for p in ("weight", "bias"):
            out[f"layers.{i}.attn.qkv.{p}"] = torch.cat(
                [f32(sd[f"{b}self_attn.{n}_proj.{p}"])
                 for n in ("q", "k", "v")], dim=0)
            for mine, theirs in names.items():
                out[f"layers.{i}.{mine}.{p}"] = f32(sd[f"{b}{theirs}.{p}"])
    return out


def maeast_from_state_dict(sd: Mapping, variant: str = "frame",
                           device="cuda") -> MAEASTEncoder:
    """The authors' state dict -> :class:`MAEASTEncoder` on ``device``, in
    eval mode. ``variant`` picks the frame (2x128) or patch (16x16) unfold
    that the two reference model files hard-code (mae_ast.py:30-49 against
    mae_ast_patch.py:30-49: both 256-d patches, so the weights cannot
    tell)."""
    port = convert_maeast_checkpoint(sd)
    D = port["patch_proj.weight"].shape[0]
    cfg = MAEASTConfig(
        embed_dim=D, depth=sum(1 for k in port if k.endswith("qkv.weight")),
        num_heads=heads_for_dim(D),
        ffn_dim=port["layers.0.mlp.fc1.weight"].shape[0],
        kernel=(2, 128) if variant == "frame" else (16, 16),
        variant=variant)
    enc = MAEASTEncoder(cfg, device=resolve_device(device))
    enc.load_state_dict(port)
    return enc.eval()


def load_maeast_checkpoint(path: str, variant: str = "frame",
                           device="cuda") -> MAEASTEncoder:
    """A released MAE-AST ``.pt`` (``{'model': state_dict}``, a trusted
    third-party fairseq file that pickles more than tensors, read with
    ``weights_only=False`` as the JAX loader reads it) ->
    :class:`MAEASTEncoder`."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    return maeast_from_state_dict(unwrap(ckpt, "model"), variant, device)


def maeast_fbank(wav: torch.Tensor) -> torch.Tensor:
    """[B, L] waveforms -> the raw Kaldi fbank [B, T, 128] (reference
    MAEASTPredModule.transform, mae_ast_module.py:54-64: povey window,
    10 ms shift, no mean removal, no normalization)."""
    from audiossl_tpu_torch.compat.beats import kaldi_fbank

    return kaldi_fbank(wav, num_mel_bins=128, window_type="povey")


@dataclasses.dataclass
class MAEASTAdapter:
    """MAE-AST as a frame encoder of the SED drivers (reference
    mae_ast_module.py / mae_ast_patch_module.py): the 100 fps fbank ->
    25 fps (frame variant) or 6.25 fps (patch variant)."""
    encoder: MAEASTEncoder

    @property
    def embed_dim(self):
        return self.encoder.embed_dim

    @property
    def frame_rate_divisor(self):
        return 4 if self.encoder.cfg.variant == "frame" else 16

    def token_count(self, n_samples: int) -> int:
        frames = snip_frames(n_samples)
        if self.encoder.cfg.variant == "frame":
            return (frames // 2 + 1) // 2
        return frames // 16

    def frame_embeddings(self, wav, valid,
                         dps: Optional[torch.Tensor] = None):
        """-> [B, T', D]; ``valid`` and ``dps`` are not read."""
        with torch.no_grad():
            fb = maeast_fbank(wav)
        return self.encoder(fb)
