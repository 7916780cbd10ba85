"""Seeded random checkpoints of the comparison encoders in their authors'
layouts, for the CPU tests and ``chip_smoke.py`` (no released checkpoint
is fetched): :func:`authors_checkpoint` returns what a released file holds
(the object ``torch.save`` writes and the ``load_*_checkpoint`` functions
read), :func:`encoder_from_checkpoint` builds the port's encoder from it
through the ``*_from_state_dict`` functions, with no file.

Weights are N(0, 0.02) (biases too), LayerNorm and BatchNorm scales
1 + N(0, 0.1), BatchNorm running statistics away from 0 and 1, and every
family carries keys its loader must leave out (a classifier head, a
decoder, a mask embedding), so a loader that reads them fails.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

# each comparison arch's family: the compat module that builds it
FAMILY = {"audioMAE": "audiomae", "beats": "beats", "byola": "byola",
          "maeast": "maeast", "mmd": "m2d", "patchmaeast": "maeast",
          "patchssast": "ssast", "ssast": "ssast"}
ARCHS = tuple(sorted(FAMILY))


class _Draw:
    def __init__(self, seed: int):
        self.rng = np.random.RandomState(seed)

    def w(self, *shape, std=0.02) -> torch.Tensor:
        return torch.from_numpy(
            (self.rng.standard_normal(shape) * std).astype(np.float32))

    def scale(self, n) -> torch.Tensor:
        return 1.0 + self.w(n, std=0.1)

    def linear(self, sd, key, n_out, n_in):
        sd[key + ".weight"] = self.w(n_out, n_in)
        sd[key + ".bias"] = self.w(n_out)

    def norm(self, sd, key, n):
        sd[key + ".weight"] = self.scale(n)
        sd[key + ".bias"] = self.w(n)


def timm_vit_state_dict(draw: _Draw, width: int, depth: int, n_pos: int,
                        patch=(16, 16), prefix: str = "", dist: bool = False
                        ) -> Dict[str, torch.Tensor]:
    """timm's ViT naming: ``n_pos`` position rows, the prefix tokens
    included; a classifier head the loaders drop."""
    D = width
    sd = {prefix + "patch_embed.proj.weight": draw.w(D, 1, *patch),
          prefix + "patch_embed.proj.bias": draw.w(D),
          prefix + "cls_token": draw.w(1, 1, D),
          prefix + "pos_embed": draw.w(1, n_pos, D)}
    if dist:
        sd[prefix + "dist_token"] = draw.w(1, 1, D)
    for i in range(depth):
        b = f"{prefix}blocks.{i}."
        draw.norm(sd, b + "norm1", D)
        draw.linear(sd, b + "attn.qkv", 3 * D, D)
        draw.linear(sd, b + "attn.proj", D, D)
        draw.norm(sd, b + "norm2", D)
        draw.linear(sd, b + "mlp.fc1", 4 * D, D)
        draw.linear(sd, b + "mlp.fc2", D, 4 * D)
    draw.norm(sd, prefix + "norm", D)
    draw.linear(sd, prefix + "head", 7, D)  # not read
    return sd


def maeast_state_dict(draw: _Draw, width: int, depth: int,
                      ffn: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """The raw MAE_AST naming of fairseq (q, k and v apart), with the
    decoder and mask embeddings the features-only path leaves out."""
    D, ffn = width, ffn or 4 * width
    sd = {"batch_norm.running_mean": torch.tensor([-3.1]),
          "batch_norm.running_var": torch.tensor([4.7]),
          "batch_norm.num_batches_tracked": torch.tensor(10),
          "enc_mask_emb": draw.w(D), "dec_mask_emb": draw.w(D)}
    draw.linear(sd, "post_extract_proj", D, 256)
    draw.norm(sd, "encoder.layer_norm", D)
    draw.norm(sd, "layer_norm", 256)  # the unused model-level norm
    for i in range(depth):
        b = f"encoder.layers.{i}."
        for n in ("q", "k", "v", "out"):
            draw.linear(sd, f"{b}self_attn.{n}_proj", D, D)
        draw.norm(sd, b + "self_attn_layer_norm", D)
        draw.linear(sd, b + "fc1", ffn, D)
        draw.linear(sd, b + "fc2", D, ffn)
        draw.norm(sd, b + "final_layer_norm", D)
    draw.linear(sd, "decoder.layers.0.fc1", 8, D)
    draw.linear(sd, "final_proj_reconstruction", 256, D)
    return sd


def beats_cfg(width: int, depth: int, embed: Optional[int] = None,
              conv_pos: int = 128, conv_pos_groups: int = 16) -> dict:
    from audiossl_tpu_torch.compat.vit import heads_for_dim

    return {"input_patch_size": 16, "embed_dim": embed or 512,
            "conv_bias": False, "encoder_layers": depth,
            "encoder_embed_dim": width, "encoder_ffn_embed_dim": 4 * width,
            "encoder_attention_heads": heads_for_dim(width),
            "conv_pos": conv_pos, "conv_pos_groups": conv_pos_groups,
            "num_buckets": 320, "max_distance": 800,
            "layer_norm_first": False, "deep_norm": True,
            "relative_position_embedding": True, "gru_rel_pos": True,
            "finetuned_model": False}


def beats_state_dict(draw: _Draw, cfg: dict) -> Dict[str, torch.Tensor]:
    """The BEATs model's naming: the position convolution weight-normed
    (``weight_g`` [1, 1, k], ``weight_v``), the relative bias table on
    every layer (layer 0's is read)."""
    E, D = cfg["embed_dim"], cfg["encoder_embed_dim"]
    H, L = cfg["encoder_attention_heads"], cfg["encoder_layers"]
    k, g = cfg["conv_pos"], cfg["conv_pos_groups"]
    sd = {"patch_embedding.weight": draw.w(E, 1, 16, 16),
          "encoder.pos_conv.0.weight_g": 1.0 + draw.w(1, 1, k, std=0.1),
          "encoder.pos_conv.0.weight_v": draw.w(D, D // g, k),
          "encoder.pos_conv.0.bias": draw.w(D)}
    draw.norm(sd, "layer_norm", E)
    draw.linear(sd, "post_extract_proj", D, E)
    draw.norm(sd, "encoder.layer_norm", D)
    for i in range(L):
        b = f"encoder.layers.{i}."
        sd[b + "self_attn.relative_attention_bias.weight"] = draw.w(
            cfg["num_buckets"], H, std=0.5)
        for n in ("q", "k", "v", "out"):
            draw.linear(sd, f"{b}self_attn.{n}_proj", D, D)
        draw.linear(sd, b + "self_attn.grep_linear", 8, D // H)
        sd[b + "self_attn.grep_a"] = draw.scale(H).reshape(1, H, 1, 1)
        draw.norm(sd, b + "self_attn_layer_norm", D)
        draw.linear(sd, b + "fc1", cfg["encoder_ffn_embed_dim"], D)
        draw.linear(sd, b + "fc2", D, cfg["encoder_ffn_embed_dim"])
        draw.norm(sd, b + "final_layer_norm", D)
    return sd


def byola_state_dict(draw: _Draw, n_mels: int = 64, d: int = 3072
                     ) -> Dict[str, torch.Tensor]:
    """AudioNTT2022Encoder's Sequential naming (base_d 64, 2048 hidden)."""
    sd = {}
    feat = 64 * (n_mels // 4)
    for ci, bi, cin in ((0, 1, 1), (4, 5, 64)):
        sd[f"features.{ci}.weight"] = draw.w(64, cin, 3, 3, std=0.2)
        sd[f"features.{ci}.bias"] = draw.w(64)
        draw.norm(sd, f"features.{bi}", 64)
        sd[f"features.{bi}.running_mean"] = draw.w(64, std=0.3)
        sd[f"features.{bi}.running_var"] = 1.0 + draw.w(64, std=0.3).abs()
        sd[f"features.{bi}.num_batches_tracked"] = torch.tensor(100)
    draw.linear(sd, "fc.0", 2048, feat)
    draw.linear(sd, "fc.3", d - feat, 2048)
    return sd


def authors_checkpoint(arch: str, width: int = 768, depth: int = 12,
                       seed: int = 0, beats_embed: Optional[int] = None,
                       conv_pos: int = 128, conv_pos_groups: int = 16
                       ) -> dict:
    """What a released ``arch`` file holds, at ``width`` and ``depth``
    (defaults: the families' released base sizes; BEATs' patch embedding
    512 wide unless ``beats_embed``):

    * AudioMAE: ``{'model': timm ViT, 513 positions}``;
    * M2D (``mmd``): ``{'model': timm ViT, 66 positions}`` (80 x 208
      inputs, 16 x 16 patches);
    * SSAST (both variants): the DataParallel ``module.v.*`` dict with
      CLS and DIST tokens, a (128, 2) patch embedding, 1024 pretraining
      frames and ``p_input_fdim`` / ``p_input_tdim`` (514 positions: the
      patch variant's 8 x 64 grid as well);
    * MAE-AST (both variants): ``{'model': raw MAE_AST}``;
    * BEATs: ``{'cfg': dict, 'model': BEATs}``;
    * BYOL-A: ``{'state_dict': {'model.' + Sequential names}}``.
    """
    draw = _Draw(seed)
    fam = FAMILY[arch]
    if fam == "audiomae":
        return {"model": timm_vit_state_dict(draw, width, depth, 513)}
    if fam == "m2d":
        sd = timm_vit_state_dict(draw, width, depth, 66)
        sd["mask_token"] = draw.w(1, 1, width)  # not read
        return {"model": sd}
    if fam == "ssast":
        sd = timm_vit_state_dict(draw, width, depth, 514, patch=(128, 2),
                                 prefix="module.v.", dist=True)
        sd["module.p_input_fdim"] = torch.tensor(128)
        sd["module.p_input_tdim"] = torch.tensor(1024)
        return sd
    if fam == "maeast":
        return {"model": maeast_state_dict(draw, width, depth)}
    if fam == "beats":
        cfg = beats_cfg(width, depth, beats_embed, conv_pos, conv_pos_groups)
        return {"cfg": cfg, "model": beats_state_dict(draw, cfg)}
    return {"state_dict": {"model." + k: v
                           for k, v in byola_state_dict(draw).items()}}


def encoder_from_checkpoint(arch: str, ckpt: dict, device="cuda"):
    """The port's encoder of ``arch`` from :func:`authors_checkpoint`'s
    object, as its ``load_*_checkpoint`` reads the file, with no file."""
    from audiossl_tpu_torch.compat import (audiomae, beats, byola, m2d,
                                           maeast, ssast)

    variant = "patch" if arch.startswith("patch") else "frame"
    fam = FAMILY[arch]
    if fam == "audiomae":
        return audiomae.audiomae_from_state_dict(ckpt["model"], device)
    if fam == "m2d":
        return m2d.m2d_from_state_dict(ckpt["model"], device=device)
    if fam == "ssast":
        return ssast.ssast_from_state_dict(ckpt, variant, device=device)
    if fam == "maeast":
        return maeast.maeast_from_state_dict(ckpt["model"], variant, device)
    if fam == "beats":
        return beats.beats_from_state_dict(ckpt["model"], ckpt["cfg"], device)
    sd = {k[len("model."):]: v for k, v in ckpt["state_dict"].items()}
    return byola.byola_from_state_dict(sd, device=device)
