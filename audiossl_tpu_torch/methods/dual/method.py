"""Dual-branch pretraining, end to end on the device (PyTorch port of
``audiossl_tpu/methods/dual/method.py``; reference ``methods/dual/``,
experimental).

Two CLS-free encoders see the same masked mel through different patch
geometries, a "patch" branch (16 x 16 patches) and a "frame" branch
(64 x 4), and train with:

* each branch's masked mel reconstruction (MSE on the masked patches);
* a cross-branch consistency MSE between the expanded embeddings of each
  branch's tokens pooled 4 at a time onto the common grid of 16-frame
  groups, on the masked groups;
* the VICReg-style variance term mean(relu(1 - std)) of each branch's
  expanded embeddings.

The encoders take the port's routes (``models/atst.py``): with
``fused_attention`` in f32 the MHA kernel K6 and ``LayerNormPG`` (K8), in
bf16 the trainable block kernels K4/K5 and K8 for the final norms. The
reconstructions, expanders and losses compute in f32, as flax's ``Dense``
promotes the encoders' bf16 output. There is no teacher: K7 runs AdamW
alone.

Both branch masks repeat the G = T // 16 group mask 4 times, so the frame
branch's T // 4 tokens must number 4 G: T mod 16 < 4. JAX fails at other
lengths (6.0 s: 601 frames, a ``TypeError`` in a broadcast); the port
refuses them in :class:`DualConfig`.

Every random number of a step (the crop starts, the block mask's
uniforms, each encoder's drop-path multipliers) comes from
:func:`draw_step` as a :class:`DualDraws`, so a caller (the tests) can
hand in others, such as the JAX package's. Under a process group every
rank draws the global batch's numbers and takes its rows; the masked
MSEs' counts and the variance terms' statistics span the global batch,
and each rank's loss is its share of the global loss.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from audiossl_tpu_torch.kernels.build import resolve_device
from audiossl_tpu_torch.models.atst import AudioTransformer, patchify
from audiossl_tpu_torch.models.byol import lecun_normal_
from audiossl_tpu_torch.models.transformer import drop_path_multipliers
from audiossl_tpu_torch.ops.masking import draw_token_mask, make_token_mask
from audiossl_tpu_torch.ops.melspec import MelConfig, log_melspec
from audiossl_tpu_torch.parallel.mesh import (all_reduce_sum, data_world,
                                              global_batch_size, local_rows)
from audiossl_tpu_torch.training.pretrain import (OptimizerConfig,
                                                  PretrainState,
                                                  init_pretrain_state,
                                                  make_pretrain_step)
from audiossl_tpu_torch.transforms.augment import (draw_crop, random_crop_wav,
                                                   wav_to_f32)

# (width, blocks, heads); tiny is the CPU tests' tier, as ast_tiny
ARCHS = {"tiny": (64, 2, 2), "small": (384, 12, 6), "base": (768, 12, 12)}
DROP_PATH_RATE = 0.1  # the JAX encoders' default, ramped over depth


def variance_loss(z: torch.Tensor, eps: float = 1e-4):
    """(mean(relu(1 - std)), mean(std)) of the per-column std of z [n, d]
    (the population variance, as ``jnp.var``; reference model.py:25-39).
    Under a process group the rows are every rank's: the mean and the
    variance come from sums over ranks."""
    n = all_reduce_sum(torch.tensor(float(z.shape[0]), device=z.device))
    mean = all_reduce_sum(z.sum(dim=0)) / n
    var = all_reduce_sum(((z - mean) ** 2).sum(dim=0)) / n
    std = torch.sqrt(var + eps)
    return F.relu(1.0 - std).mean(), std.mean()


@dataclasses.dataclass(frozen=True)
class DualConfig:
    """The JAX package's ``DualConfig``. A crop whose frame count T does
    not satisfy T mod 16 < 4 raises ``ValueError`` (module docstring)."""
    arch: str = "small"
    sr: int = 16000
    anchor_len: float = 6.0
    mask_ratio: float = 0.65
    mask_len: int = 5
    expander_dim: int = 8192
    out_dim: int = 256
    optimizer: OptimizerConfig = OptimizerConfig()
    mel: MelConfig = MelConfig()
    dtype: str = "float32"
    # the kernel routes of the encoders (module docstring); False runs the
    # module path
    fused_attention: bool = True

    def __post_init__(self):
        T = self.out_frames
        if T // 4 != 4 * (T // 16):
            raise ValueError(
                f"dual: anchor_len {self.anchor_len} s gives T = {T} frames, "
                f"and the frame branch's T // 4 = {T // 4} tokens must equal "
                f"the 4 * (T // 16) = {4 * (T // 16)} that both branch masks "
                "repeat from the 16-frame groups: T mod 16 must be below 4 "
                "(6.4 s and 0.5 s pass; JAX fails at the others)")

    @property
    def out_samples(self) -> int:
        return int(self.anchor_len * self.sr)

    @property
    def out_frames(self) -> int:
        return self.out_samples // self.mel.hop_length + 1

    @property
    def n_groups(self) -> int:
        """The common time grid: 16-frame groups."""
        return self.out_frames // 16


class _Expander(nn.Module):
    """fc0 -> LayerNorm -> ReLU -> fc1 -> LayerNorm -> ReLU -> fc2 (the
    reference's build_expander), in f32; flax's default LayerNorm epsilon,
    1e-6."""

    def __init__(self, in_dim: int, hidden: int, out: int, device=None):
        super().__init__()
        self.fc0 = nn.Linear(in_dim, hidden, device=device)
        self.ln0 = nn.LayerNorm(hidden, eps=1e-6, device=device)
        self.fc1 = nn.Linear(hidden, hidden, device=device)
        self.ln1 = nn.LayerNorm(hidden, eps=1e-6, device=device)
        self.fc2 = nn.Linear(hidden, out, device=device)

    def forward(self, x):
        x = F.relu(self.ln0(self.fc0(x)))
        x = F.relu(self.ln1(self.fc1(x)))
        return self.fc2(x)


def _share(num: torch.Tensor, count: torch.Tensor) -> torch.Tensor:
    """num / max(count, 1) with the count summed over ranks: this rank's
    share of a masked mean over the global batch."""
    return num / torch.clamp(all_reduce_sum(count.detach().float()), min=1.0)


class DualModel(nn.Module):
    """JAX's ``DualModel`` with its module names. The encoders are the
    port's ``AudioTransformer`` (reference ViT init); the reconstructions
    and expanders are drawn as flax's ``Dense`` (LeCun normal kernels,
    zero biases)."""

    def __init__(self, cfg: DualConfig, generator: torch.Generator = None,
                 plain: bool = False):
        super().__init__()
        self.cfg = cfg
        gen = generator if generator is not None else \
            torch.Generator().manual_seed(0)
        d, depth, heads = ARCHS[cfg.arch]
        kw = dict(embed_dim=d, depth=depth, num_heads=heads,
                  spec_h=cfg.mel.n_mels, spec_w=cfg.out_frames,
                  use_cls=False, dtype=getattr(torch, cfg.dtype),
                  fused_attention=cfg.fused_attention, plain=plain,
                  device="cpu", generator=gen)
        self.patchnet = AudioTransformer(patch_h=16, patch_w=16, **kw)
        self.framenet = AudioTransformer(patch_h=64, patch_w=4, **kw)
        meta = "meta"
        self.patch_recon = nn.Linear(d, 16 * 16, device=meta)
        self.frame_recon = nn.Linear(d, 64 * 4, device=meta)
        self.patch_expander = _Expander(d, cfg.expander_dim, cfg.out_dim,
                                        meta)
        self.frame_expander = _Expander(d, cfg.expander_dim, cfg.out_dim,
                                        meta)
        heads_ = (self.patch_recon, self.frame_recon, self.patch_expander,
                  self.frame_expander)
        with torch.no_grad():
            for h in heads_:
                h.to_empty(device="cpu")
                for m in h.modules():
                    if isinstance(m, nn.Linear):
                        lecun_normal_(m.weight, gen)
                        m.bias.zero_()
                    elif isinstance(m, nn.LayerNorm):
                        m.weight.fill_(1.0)
                        m.bias.zero_()

    def forward(self, mel: torch.Tensor, mask_groups: torch.Tensor,
                patch_dp=None, frame_dp=None):
        """mel [B, F, T]; mask_groups [B, G] (bool) over the 16-frame grid;
        each encoder's drop-path keep multipliers [depth, 2, B] or None.
        Returns (this rank's share of the loss, the seven aux values of
        the global batch, detached)."""
        B = mel.shape[0]
        G = mask_groups.shape[1]
        # the patch branch's tokens run time-major (4 frequency rows a
        # group), the frame branch's 4 a group
        mask = torch.repeat_interleave(mask_groups, 4, dim=1)  # [B, 4G]
        hp, _ = self.patchnet(mel, None, mask_index=mask, apply_mask=True,
                              dps=patch_dp)
        hf, _ = self.framenet(mel, None, mask_index=mask, apply_mask=True,
                              dps=frame_dp)
        # flax's Dense promotes the encoders' output to its f32 kernels
        rec_p = self.patch_recon(hp.float())
        rec_f = self.frame_recon(hf.float())
        tgt_p = patchify(mel, 16, 16)[:, :4 * G]
        tgt_f = patchify(mel, 64, 4)[:, :4 * G]
        w = mask.float()[:, :, None]
        count = w.sum() * rec_p.shape[-1]
        loss_mel_patch = _share((((rec_p - tgt_p) ** 2) * w).sum(), count)
        loss_mel_frame = _share((((rec_f - tgt_f) ** 2) * w).sum(), count)

        def pooled(h):  # jnp.mean of the dtype: an f32 mean, rounded
            d = h.shape[-1]
            z = h[:, :4 * G].float().reshape(B, G, 4, d).mean(dim=2)
            return z.to(h.dtype).float()

        zp = self.patch_expander(pooled(hp))
        zf = self.frame_expander(pooled(hf))
        wg = mask_groups.float()[:, :, None]
        loss_dual = _share((((zp - zf) ** 2) * wg).sum(),
                           wg.sum() * zp.shape[-1])
        lu_p, std_p = variance_loss(zp.reshape(-1, zp.shape[-1]))
        lu_f, std_f = variance_loss(zf.reshape(-1, zf.shape[-1]))
        # the variance terms are global on every rank: each adds its share
        n = data_world().size
        loss = loss_mel_patch + loss_mel_frame + loss_dual + (lu_p + lu_f) / n
        aux = {"loss_mel_patch": all_reduce_sum(loss_mel_patch.detach()),
               "loss_mel_frame": all_reduce_sum(loss_mel_frame.detach()),
               "loss_dual": all_reduce_sum(loss_dual.detach()),
               "loss_uniform_patch": lu_p.detach(),
               "loss_uniform_frame": lu_f.detach(),
               "std_patch": std_p.detach(), "std_frame": std_f.detach()}
        return loss, aux


@dataclasses.dataclass
class DualDraws:
    """Every random number of one step: crop-start uniforms [B], the block
    mask's ``u_round`` [B] and ``u_starts`` [B, G], and each encoder's
    drop-path keep multipliers [depth, 2, B]."""
    crop: torch.Tensor
    mask: Dict[str, torch.Tensor]
    patch_dp: torch.Tensor
    frame_dp: torch.Tensor


def draw_step(gen: torch.Generator, cfg: DualConfig, batch: int,
              device) -> DualDraws:
    depth = ARCHS[cfg.arch][1]
    crop = draw_crop(gen, batch, device)
    mask = draw_token_mask(gen, batch, cfg.n_groups, cfg.mask_ratio,
                           "block", cfg.mask_len, device=device)
    dps = [drop_path_multipliers(
        torch.rand(depth, 2, batch, generator=gen, device=device),
        DROP_PATH_RATE) for _ in range(2)]
    return DualDraws(crop=crop, mask=mask, patch_dp=dps[0], frame_dp=dps[1])


def local_draws(draws: DualDraws, batch: int) -> DualDraws:
    """This rank's rows of the draws of a global batch of ``batch``."""
    sl = local_rows(batch)
    return DualDraws(crop=draws.crop[sl],
                     mask={k: v[sl] for k, v in draws.mask.items()},
                     patch_dp=draws.patch_dp[:, :, sl],
                     frame_dp=draws.frame_dp[:, :, sl])


class DualMethod:
    """The dual model and its step, as the runner calls them (``device``,
    ``cfg``, ``init_state``, ``make_step``).

    Parameters are drawn on the CPU from ``seed`` and moved to ``device``,
    the card unless the caller asks for the CPU (without a card that
    raises); ``plain=True`` runs every kernel's plain version."""

    def __init__(self, cfg: DualConfig, device="cuda", seed: int = 0,
                 plain: bool = False):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.plain = plain
        self.model = DualModel(cfg, torch.Generator().manual_seed(seed),
                               plain)
        self.model.to(self.device)
        self.depth = ARCHS[cfg.arch][1]

    def init_state(self, seed: int = 0) -> PretrainState:
        """Zero moments, no teacher, the step's generator on the device
        seeded with ``seed``."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        return init_pretrain_state(self.model, None, gen)

    def draw(self, gen: torch.Generator, batch: int) -> DualDraws:
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
        draws = local_draws(draws, n)
        crop_len = torch.full((B,), cfg.out_samples, device=self.device,
                              dtype=torch.long)
        crops, crop_valid = random_crop_wav(wav, valid, crop_len,
                                            cfg.out_samples, draws.crop)
        mel = log_melspec(crops, crop_valid, cfg.mel, plain=self.plain)
        mask = make_token_mask(draws.mask, cfg.mask_ratio, "block",
                               cfg.mask_len)
        return model(mel, mask, draws.patch_dp, draws.frame_dp)

    def make_step(self):
        return make_pretrain_step(self.cfg.optimizer, self.forward_loss,
                                  self.plain)
