"""The shared timm-style Vision Transformer of the third-party comparison
encoders (PyTorch port of ``audiossl_tpu/compat/vit.py``; reference
``downstream/comparison_models/models/``):

* AudioMAE  — ``audioMAE_model.py:22-59`` subclasses timm's
  ``VisionTransformer``
* M2D (mmd) — ``models_mae.py:117-160`` builds from timm's ``PatchEmbed``
  and ``Block``
* SSAST     — ``ssast.py:73-85`` builds timm's DeiT (distilled: CLS and
  DIST prefix tokens)

All three share one encoder: a single-channel patch embedding with kernel
= stride (here the patches as rows and one Linear, as the JAX package
takes them), prefix token(s) and an additive position embedding, pre-norm
ViT blocks (the port's ``models.transformer.Block`` with ``qkv_bias``:
the A&S GELU and the module route, as JAX's ``Block`` runs without
``fused_attention``; no kernel), and a final LayerNorm.

:func:`convert_timm_vit_state_dict` maps a state dict in timm's naming
(``blocks.N.attn.qkv`` and so on), the layout of the three families'
released checkpoints, onto :class:`TimmViT`.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from audiossl_tpu_torch.models.transformer import Block


def extract_patches(x: torch.Tensor, ph: int, pw: int) -> torch.Tensor:
    """[B, H, W] single-channel image -> non-overlapping patches
    [B, (H//ph)*(W//pw), ph*pw], flattened as torch ``Conv2d(k=s=(ph,
    pw))`` + ``flatten(2).transpose(1, 2)`` orders them: patch index
    H-major, patch content (ph, pw) row-major."""
    B, H, W = x.shape
    h, w = H // ph, W // pw
    x = x[:, : h * ph, : w * pw]
    x = x.reshape(B, h, ph, w, pw).permute(0, 1, 3, 2, 4)
    return x.reshape(B, h * w, ph * pw)


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    embed_dim: int = 768
    depth: int = 12
    num_heads: int = 12
    mlp_ratio: float = 4.0
    patch_size: Tuple[int, int] = (16, 16)
    # prefix tokens before the patches: 1 = CLS (AudioMAE, M2D), 2 = CLS +
    # DIST (SSAST's DeiT-distilled backbones)
    num_prefix: int = 1
    # the position embedding holds num_prefix + max_patches rows
    max_patches: int = 512
    # (rows, cols) of the position embedding's patch grid when the
    # variable input axis is the minor (W, time) one, as SSAST-patch's
    # freq-major 8 x T' grid; None: the variable axis is the major one
    # (AudioMAE and M2D time-major grids, SSAST-frame's single row), where
    # the leading slice is right
    pos_grid: Optional[Tuple[int, int]] = None
    ln_eps: float = 1e-6


class TimmViT(nn.Module):
    """Encoder trunk: [B, H, W] -> normed tokens [B, prefix + N, D].

    An input with fewer than ``max_patches`` patches takes the leading
    slice of the position embedding (the reference's ``pos_embed[:,
    1:T+1]``, audioMAE_module.py:48), or with ``cfg.pos_grid`` the leading
    columns of each grid row (SSAST-patch; the reference's own module
    fails on such inputs, the grid slice is the consistent extension)."""

    def __init__(self, cfg: ViTConfig = ViTConfig(), device=None):
        super().__init__()
        self.cfg = cfg
        D = cfg.embed_dim
        ph, pw = cfg.patch_size
        self.patch_proj = nn.Linear(ph * pw, D, device=device)
        self.pos_embed = nn.Parameter(torch.zeros(
            cfg.num_prefix + cfg.max_patches, D, device=device))
        self.prefix_tokens = nn.Parameter(torch.zeros(cfg.num_prefix, D,
                                                      device=device))
        self.blocks = nn.ModuleList(
            Block(D, cfg.num_heads, cfg.mlp_ratio, qkv_bias=True,
                  eps=cfg.ln_eps, device=device) for _ in range(cfg.depth))
        self.norm = nn.LayerNorm(D, eps=cfg.ln_eps, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = self.cfg
        B = x.shape[0]
        patches = extract_patches(x.float(), *c.patch_size)
        N = patches.shape[1]
        tok = self.patch_proj(patches)
        pos = self.pos_embed
        if N != c.max_patches and c.pos_grid is not None:
            rows, cols0 = c.pos_grid
            if rows * cols0 != c.max_patches or N % rows:
                raise ValueError(
                    f"pos_grid {c.pos_grid} inconsistent with "
                    f"max_patches={c.max_patches} / N={N}")
            ppatch = pos[c.num_prefix:].reshape(rows, cols0, -1)
            ppatch = ppatch[:, : N // rows].reshape(N, -1)
        else:
            ppatch = pos[c.num_prefix: c.num_prefix + N]
        tok = tok + ppatch
        lead = (self.prefix_tokens + pos[: c.num_prefix])[None]
        tok = torch.cat([lead.expand(B, -1, -1), tok], dim=1)
        for blk in self.blocks:
            tok = blk(tok)
        return self.norm(tok)


# --------------------------- torch importer --------------------------- #

def f32(t) -> torch.Tensor:
    """A tensor or array as a float32 CPU tensor of its own."""
    if isinstance(t, torch.Tensor):
        return t.detach().to("cpu", torch.float32).clone()
    return torch.from_numpy(np.array(t, np.float32))


def infer_depth(sd, prefix: str = "") -> int:
    """Number of blocks in a timm-layout state dict."""
    ns = [int(k[len(prefix):].split(".")[1]) for k in sd
          if k.startswith(prefix + "blocks.")]
    return max(ns) + 1


def heads_for_dim(embed_dim: int) -> int:
    """ViT head count for an embed dim: timm's tiny / small / base table,
    dim / 64 otherwise (every released family is in the table; the
    fallback sizes small test checkpoints)."""
    return {768: 12, 384: 6, 192: 3}.get(embed_dim,
                                         max(1, embed_dim // 64))


def convert_timm_vit_state_dict(sd: Mapping, depth: int, prefix: str = "",
                                dist_token: bool = False
                                ) -> Dict[str, torch.Tensor]:
    """timm-layout state dict -> :class:`TimmViT`'s state dict.

    ``prefix`` addresses nested checkpoints (SSAST's ``v.``). Keys read:
    ``patch_embed.proj.{weight,bias}`` (Conv2d [D, 1, ph, pw] -> Linear
    [D, ph*pw]), ``cls_token`` (and ``dist_token``), ``pos_embed``,
    ``blocks.N.{norm1,attn.qkv,attn.proj,norm2,mlp.fc1,mlp.fc2}`` and
    ``norm``; no other."""
    def arr(key):
        return f32(sd[prefix + key])

    w = arr("patch_embed.proj.weight")  # [D, 1, ph, pw]
    out = {"patch_proj.weight": w.reshape(w.shape[0], -1),
           "patch_proj.bias": arr("patch_embed.proj.bias")}
    toks = [arr("cls_token").reshape(1, -1)]
    if dist_token:
        toks.append(arr("dist_token").reshape(1, -1))
    out["prefix_tokens"] = torch.cat(toks, dim=0)
    out["pos_embed"] = arr("pos_embed").reshape(-1, w.shape[0])
    names = ["norm1.weight", "norm1.bias", "attn.qkv.weight", "attn.qkv.bias",
             "attn.proj.weight", "attn.proj.bias", "norm2.weight",
             "norm2.bias", "mlp.fc1.weight", "mlp.fc1.bias",
             "mlp.fc2.weight", "mlp.fc2.bias"]
    for i in range(depth):
        for n in names:
            out[f"blocks.{i}.{n}"] = arr(f"blocks.{i}.{n}")
    out["norm.weight"] = arr("norm.weight")
    out["norm.bias"] = arr("norm.bias")
    return out


def prefixed(sd: Mapping[str, torch.Tensor], prefix: str
             ) -> Dict[str, torch.Tensor]:
    return {prefix + k: v for k, v in sd.items()}


def unwrap(ckpt, *keys):
    """A loaded checkpoint's state dict: the first of ``keys`` it holds,
    else itself."""
    for k in keys:
        if isinstance(ckpt, Mapping) and k in ckpt:
            return ckpt[k]
    return ckpt


# ------------------------ sin-cos pos embeds -------------------------- #

def sincos_pos_embed_1d(embed_dim: int, positions: np.ndarray) -> np.ndarray:
    """MAE-style 1-D sin-cos table [len(positions), embed_dim]: first half
    sin, second half cos (reference models_mae.py:54-72)."""
    assert embed_dim % 2 == 0
    omega = np.arange(embed_dim // 2, dtype=np.float64)
    omega = 1.0 / 10000 ** (omega / (embed_dim / 2.0))
    out = np.einsum("m,d->md", positions.reshape(-1).astype(np.float64),
                    omega)
    return np.concatenate([np.sin(out), np.cos(out)], axis=1).astype(
        np.float32)


def sincos_pos_embed_2d(embed_dim: int, gh: int, gw: int,
                        cls_token: bool = True) -> np.ndarray:
    """MAE 2-D sin-cos position embedding [gh*gw (+1), embed_dim], the grid
    flattened H-major. The reference's half split is W first: its
    ``emb_h`` comes from ``grid[0]``, which ``meshgrid(w, h)`` fills with
    the W coordinate (reference models_mae.py:24-51), so the first half of
    the dim encodes W, the second H."""
    grid_h = np.repeat(np.arange(gh, dtype=np.float32), gw)
    grid_w = np.tile(np.arange(gw, dtype=np.float32), gh)
    emb = np.concatenate(
        [sincos_pos_embed_1d(embed_dim // 2, grid_w),
         sincos_pos_embed_1d(embed_dim // 2, grid_h)], axis=1)
    if cls_token:
        emb = np.concatenate(
            [np.zeros((1, embed_dim), np.float32), emb], axis=0)
    return emb
