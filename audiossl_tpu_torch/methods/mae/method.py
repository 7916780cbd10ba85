"""Masked-autoencoder pretraining, end to end on the device (PyTorch port
of ``audiossl_tpu/methods/mae/method.py``; reference
``methods/mae/mae.py``).

The encoder sees only the kept patches and a CLS token; a small decoder
takes the encoded kept tokens and one mask token per masked patch, each
carrying its position's embedding, and regresses the masked patches of
the mel with a plain MSE. The masked count is fixed (``round(ratio *
N)``), and the kept and masked patches are a gather from a stable argsort
of uniform noise, as in JAX. The blocks run on the module route (JAX's
``Block(fused_attention=False)``), so the step launches K1 for the mel
and K7 for the update, and no block kernel. There is no teacher: K7 runs
AdamW alone (``training/pretrain.py``).

Every random number of a step (the crop starts and the mask noise) comes
from :func:`draw_step` as a :class:`MAEDraws`, so a caller (the tests) can
hand in others, such as the JAX package's. Under a process group every
rank draws the global batch's numbers and takes its rows, and its loss is
its share of the global batch's mean.
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn

from audiossl_tpu_torch.kernels.build import resolve_device
from audiossl_tpu_torch.models.atst import num_patches, patchify
from audiossl_tpu_torch.models.byol import lecun_normal_
from audiossl_tpu_torch.models.transformer import Block
from audiossl_tpu_torch.ops.melspec import MelConfig, log_melspec
from audiossl_tpu_torch.parallel.mesh import global_batch_size, local_rows
from audiossl_tpu_torch.training.pretrain import (OptimizerConfig,
                                                  PretrainState,
                                                  init_pretrain_state,
                                                  make_pretrain_step)
from audiossl_tpu_torch.transforms.augment import (draw_crop, random_crop_wav,
                                                   wav_to_f32)


@dataclasses.dataclass(frozen=True)
class MAEConfig:
    """The JAX package's ``MAEConfig``."""
    sr: int = 16000
    anchor_len: float = 6.0
    mask_ratio: float = 0.75
    patch_h: int = 16
    patch_w: int = 16
    embed_dim: int = 384
    depth: int = 12
    num_heads: int = 6
    dec_embed_dim: int = 384
    dec_depth: int = 6
    dec_num_heads: int = 6
    optimizer: OptimizerConfig = OptimizerConfig()
    mel: MelConfig = MelConfig()

    @property
    def out_samples(self) -> int:
        return int(self.anchor_len * self.sr)

    @property
    def out_frames(self) -> int:
        return self.out_samples // self.mel.hop_length + 1

    @property
    def n_patches(self) -> int:
        return num_patches(self.mel.n_mels, self.out_frames, self.patch_h,
                           self.patch_w)

    @property
    def n_masked(self) -> int:
        return int(round(self.mask_ratio * self.n_patches))


def _gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [B, N, D] at the token indices idx [B, K] -> [B, K, D] (JAX's
    ``take_along_axis``)."""
    return torch.gather(x, 1, idx[:, :, None].expand(-1, -1, x.shape[-1]))


class MAEModel(nn.Module):
    """JAX's ``MAEModel`` with its parameter names (``blocks_i`` become
    ``blocks.i``). Parameters are drawn on the CPU from ``generator`` as
    JAX initializes them: embeddings truncated normal (std 0.02, cut at 2
    std), Dense kernels flax's LeCun normal, zero biases, unit
    LayerNorms."""

    def __init__(self, cfg: MAEConfig,
                 generator: torch.Generator = None):
        super().__init__()
        self.cfg = cfg
        meta = "meta"
        n, d, dd = cfg.n_patches, cfg.embed_dim, cfg.dec_embed_dim
        self.patch_proj = nn.Linear(cfg.patch_h * cfg.patch_w, d, device=meta)
        self.pos_embed = nn.Parameter(torch.empty(1, n + 1, d, device=meta))
        self.cls_token = nn.Parameter(torch.empty(1, 1, d, device=meta))
        self.dec_pos_embed = nn.Parameter(torch.empty(1, n + 1, dd,
                                                      device=meta))
        self.mask_embed = nn.Parameter(torch.empty(1, 1, dd, device=meta))
        self.blocks = nn.ModuleList(
            Block(d, cfg.num_heads, qkv_bias=True, device=meta)
            for _ in range(cfg.depth))
        self.norm = nn.LayerNorm(d, eps=1e-6, device=meta)
        self.middle = nn.Linear(d, dd, device=meta)
        self.dec_blocks = nn.ModuleList(
            Block(dd, cfg.dec_num_heads, qkv_bias=True, device=meta)
            for _ in range(cfg.dec_depth))
        self.dec_norm = nn.LayerNorm(dd, eps=1e-6, device=meta)
        self.dec_head = nn.Linear(dd, cfg.patch_h * cfg.patch_w, device=meta)
        # built on the meta device, so nothing draws from the global RNG
        self.to_empty(device="cpu")
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator = None):
        gen = generator if generator is not None else \
            torch.Generator().manual_seed(0)
        for p in (self.pos_embed, self.cls_token, self.dec_pos_embed,
                  self.mask_embed):
            nn.init.trunc_normal_(p, std=0.02, a=-0.04, b=0.04, generator=gen)
        for m in self.modules():
            if isinstance(m, nn.Linear):
                lecun_normal_(m.weight, gen)
                m.bias.zero_()
            elif isinstance(m, nn.LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()

    def forward(self, mel: torch.Tensor, noise: torch.Tensor):
        """mel [B, F, T], noise [B, N] uniforms -> (CLS embedding [B, D],
        MSE of the masked patches). Each sample keeps the patches of its
        ``N - n_masked`` smallest noise values (a stable sort: ties keep
        their order). Under a process group the mean is over the global
        batch and the loss is this rank's share of it."""
        cfg = self.cfg
        B = mel.shape[0]
        patches = patchify(mel, cfg.patch_h, cfg.patch_w)
        n_mask = cfg.n_masked
        n_keep = patches.shape[1] - n_mask
        order = torch.argsort(noise, dim=-1, stable=True)
        keep_idx, mask_idx = order[:, :n_keep], order[:, n_keep:]

        x = self.patch_proj(patches) + self.pos_embed[:, 1:]
        cls = (self.cls_token + self.pos_embed[:, :1]).expand(B, 1, -1)
        h = torch.cat([cls, _gather(x, keep_idx)], dim=1)
        for blk in self.blocks:
            h = blk(h)
        h = self.norm(h)
        cls_out = h[:, 0]

        d = self.middle(h)
        dec_pos = self.dec_pos_embed[:, 1:].expand(B, -1, -1)
        d = torch.cat([d[:, :1] + self.dec_pos_embed[:, :1],
                       d[:, 1:] + _gather(dec_pos, keep_idx),
                       _gather(dec_pos, mask_idx) + self.mask_embed], dim=1)
        for blk in self.dec_blocks:
            d = blk(d)
        pred = self.dec_head(self.dec_norm(d)[:, -n_mask:])
        err = (pred - _gather(patches, mask_idx)) ** 2
        return cls_out, err.sum() / (global_batch_size(B) * err[0].numel())


@dataclasses.dataclass
class MAEDraws:
    """Every random number of one step: crop-start uniforms [B] and the
    mask noise [B, N]."""
    crop: torch.Tensor
    noise: torch.Tensor


def draw_step(gen: torch.Generator, cfg: MAEConfig, batch: int,
              device) -> MAEDraws:
    return MAEDraws(crop=draw_crop(gen, batch, device),
                    noise=torch.rand(batch, cfg.n_patches, generator=gen,
                                     device=device))


class MAEMethod:
    """MAE's model and step, as the runner calls them (``device``, ``cfg``,
    ``init_state``, ``make_step``).

    Parameters are drawn on the CPU from ``seed`` and moved to ``device``,
    the card unless the caller asks for the CPU (without a card that
    raises); ``plain=True`` runs K1's and K7's plain versions."""

    def __init__(self, cfg: MAEConfig, device="cuda", seed: int = 0,
                 plain: bool = False):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.plain = plain
        self.model = MAEModel(cfg, torch.Generator().manual_seed(seed))
        self.model.to(self.device)
        self.depth = cfg.depth

    def init_state(self, seed: int = 0) -> PretrainState:
        """Zero moments, no teacher, the step's generator on the device
        seeded with ``seed``."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        return init_pretrain_state(self.model, None, gen)

    def draw(self, gen: torch.Generator, batch: int) -> MAEDraws:
        """The draws of a (global) batch of ``batch`` clips."""
        return draw_step(gen, self.cfg, batch, self.device)

    def forward_loss(self, model, teacher, batch, gen, draws=None):
        cfg = self.cfg
        wav = wav_to_f32(torch.as_tensor(batch["wav"], device=self.device))
        valid = torch.as_tensor(batch["valid"], device=self.device).long()
        B = wav.shape[0]
        n = global_batch_size(B)
        if draws is None:
            draws = self.draw(gen, n)
        sl = local_rows(n)
        crop_len = torch.full((B,), cfg.out_samples, device=self.device,
                              dtype=torch.long)
        crops, crop_valid = random_crop_wav(wav, valid, crop_len,
                                            cfg.out_samples, draws.crop[sl])
        mel = log_melspec(crops, crop_valid, cfg.mel, plain=self.plain)
        _, loss = model(mel, draws.noise[sl])
        return loss, {}

    def make_step(self):
        return make_pretrain_step(self.cfg.optimizer, self.forward_loss,
                                  self.plain)
