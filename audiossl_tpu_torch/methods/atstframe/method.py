"""ATST-Frame pretraining, end to end on the device (PyTorch port of
``audiossl_tpu/methods/atstframe/method.py``).

One fixed-length crop per clip and one mel computation for the batch;
two views of it (view 1 for the teacher, view 2 for the student), each
with optional mixup and freq warp; ONE token mask shared by both views.
The student sees its inputs with the masked tokens replaced
(``apply_mask=True``), the teacher sees them whole and uses the mask to
select positions only; the loss is the symmetric cross-view frame BYOL
loss; the teacher follows the student by EMA.

Every random number of a step comes from :func:`draw_step` (a
``torch.Generator`` on the device) as a :class:`StepDraws`, and the rest
of the step is a function of those draws, so a caller (the tests) can
hand in other draws, such as the JAX package's.

Under a process group every rank draws the global batch's numbers from
its generator (seeded alike, they advance in lockstep) and takes its
rows (:func:`local_draws`); mixup's partners come from the global batch,
and the BatchNorms and the loss reduce over it (``models/byol.py``), so
the step at world size n is the step of one process on the global batch.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from audiossl_tpu_torch.kernels.build import resolve_device
from audiossl_tpu_torch.models.atst import (frame_ast_base, frame_ast_small,
                                            frame_ast_tiny)
from audiossl_tpu_torch.models.byol import frame_byol_loss
from audiossl_tpu_torch.models.transformer import drop_path_multipliers
from audiossl_tpu_torch.ops.masking import draw_token_mask, make_token_mask
from audiossl_tpu_torch.ops.melspec import MelConfig, log_melspec
from audiossl_tpu_torch.parallel.mesh import (all_gather_rows,
                                              global_batch_size, local_rows,
                                              world)
from audiossl_tpu_torch.training.pretrain import (Branch, OptimizerConfig,
                                                  PretrainState,
                                                  init_pretrain_state,
                                                  make_pretrain_step)
from audiossl_tpu_torch.transforms.augment import (draw_crop, draw_mixup,
                                                   draw_resize_crop,
                                                   mixup_log, random_crop_wav,
                                                   random_resize_crop, rows_of,
                                                   view_major_rows, wav_to_f32)

_ARCHS = {"tiny": frame_ast_tiny, "small": frame_ast_small,
          "base": frame_ast_base}


@dataclasses.dataclass(frozen=True)
class FramePretrainConfig:
    """The JAX package's ``FramePretrainConfig`` (defaults = the published
    recipe, reference methods/atstframe/train_base.sh), plus the encoders'
    ``drop_path_rate`` (the JAX encoders' default, 0.1). ``avg_blocks`` > 0
    is the data2vec variant: a student with a linear projector and no
    predictor against a teacher whose target is the mean of its last
    ``avg_blocks`` instance-normalized block outputs, with no head."""
    arch: str = "small"
    sr: int = 16000
    anchor_len: float = 10.0
    symmetric: bool = True
    aug_tea: bool = True
    aug_stu: bool = True
    mix_up: bool = True
    freq_wrap: bool = True
    mask_ratio: float = 0.65
    mask_type: str = "block"
    mask_len: int = 5
    min_mask_len: int = 2
    mixup_ratio: float = 0.4
    avg_blocks: int = 0
    pos_type: str = "cut"
    patch_h: int = 64
    patch_w: int = 4
    optimizer: OptimizerConfig = OptimizerConfig()
    mel: MelConfig = MelConfig(stft_precision="default")
    dtype: str = "float32"
    # the kernels: in bf16 K4/K5 for the student and K2/K3 for the
    # teacher, in f32 K6 and LayerNormPG (K8) for both; False runs the
    # module path for both
    fused_attention: bool = True
    drop_path_rate: float = 0.1
    # opt-in int8 recipes on the bf16 block-kernel route (no effect in
    # f32): "int8" runs the no-grad teacher's products in int8 (K2q/K3q);
    # "int8" / "int8dx" the student's forward products (K4q/K5q forward,
    # the backward on the dequantized weights) / and its grad-to-input
    # products (K4q/K5q backward)
    teacher_quant: str = "none"
    student_quant: str = "none"

    @property
    def out_frames(self) -> int:
        return int(self.anchor_len * self.sr) // self.mel.hop_length + 1

    @property
    def out_samples(self) -> int:
        return int(self.anchor_len * self.sr)

    @property
    def num_patches(self) -> int:
        return (self.mel.n_mels // self.patch_h) * (self.out_frames
                                                    // self.patch_w)


@dataclasses.dataclass
class StepDraws:
    """Every random number of one step. ``mix``/``rrc`` hold (teacher view,
    student view) entries, None where the view is not augmented: mixup
    (a [B], shift [B]) and freq-warp (h uniforms [B], offset uniforms [B]).
    ``student_dp``/``teacher_dp`` are keep multipliers [depth, 2, S] (S the
    branch's batch), None without stochastic depth."""
    crop: torch.Tensor
    mix: Tuple[Optional[Tuple[torch.Tensor, torch.Tensor]], ...]
    rrc: Tuple[Optional[Tuple[torch.Tensor, torch.Tensor]], ...]
    mask: Dict[str, torch.Tensor]
    student_dp: Optional[torch.Tensor]
    teacher_dp: Optional[torch.Tensor]


def draw_step(gen: torch.Generator, cfg: FramePretrainConfig, batch: int,
              depth: int, device) -> StepDraws:
    """Draw a step's random numbers from ``gen`` on ``device``."""
    mix, rrc = [], []
    for enabled in (cfg.aug_tea, cfg.aug_stu):
        on = enabled and cfg.mix_up
        mix.append(draw_mixup(gen, batch, cfg.mixup_ratio, device)
                   if on else None)
        on = enabled and cfg.freq_wrap
        rrc.append(draw_resize_crop(gen, batch, device) if on else None)
    S = 2 * batch if cfg.symmetric else batch
    dps = [None, None]
    if cfg.drop_path_rate > 0.0:
        dps = [drop_path_multipliers(
            torch.rand(depth, 2, S, generator=gen, device=device),
            cfg.drop_path_rate) for _ in range(2)]
    return StepDraws(
        crop=draw_crop(gen, batch, device), mix=tuple(mix), rrc=tuple(rrc),
        mask=draw_token_mask(gen, batch, cfg.num_patches, cfg.mask_ratio,
                             cfg.mask_type, cfg.mask_len, cfg.min_mask_len,
                             device=device),
        student_dp=dps[0], teacher_dp=dps[1])


def local_draws(draws: StepDraws, batch: int) -> StepDraws:
    """This rank's rows of the draws of a global batch of ``batch``: the
    per-clip draws' rows, and the drop-path multipliers' rows of each view
    (view-major, as the encoders take them). The draws themselves in one
    process."""
    if world().size == 1:
        return draws
    sl = local_rows(batch)
    return StepDraws(
        crop=draws.crop[sl], mix=tuple(rows_of(m, sl) for m in draws.mix),
        rrc=tuple(rows_of(r, sl) for r in draws.rrc),
        mask={k: v[sl] for k, v in draws.mask.items()},
        student_dp=view_major_rows(draws.student_dp, batch, sl),
        teacher_dp=view_major_rows(draws.teacher_dp, batch, sl))


def _aug_view(mel, frames, mix, rrc, pool):
    if mix is not None:
        mel = mixup_log(mel, *mix, valid_frames=frames, pool=pool)
    if rrc is not None:
        # RandomResizeCrop((1, 1.0), time_scale=(1.0, 1.0)): freq warp
        mel = random_resize_crop(mel, *rrc, freq_scale=(0.6, 1.5),
                                 valid_frames=frames)
    return mel


def frame_train_views(wav, valid, cfg: FramePretrainConfig,
                      draws: StepDraws, plain: bool = False):
    """waveforms [B, L] -> (mel [2B, F, T], frames [2B], mask [2B, Np]):
    view 1 (teacher) then view 2 (student), from the same crop, sharing
    the same token mask. ``draws`` are this rank's (:func:`local_draws`);
    mixup's partners come from every rank's mel."""
    B = wav.shape[0]
    crop_len = torch.full((B,), cfg.out_samples, device=wav.device,
                          dtype=torch.long)
    crops, crop_valid = random_crop_wav(wav, valid, crop_len,
                                        cfg.out_samples, draws.crop)
    mel = log_melspec(crops, crop_valid, cfg.mel, plain=plain)
    frames = crop_valid // cfg.mel.hop_length + 1
    pool = (all_gather_rows(mel) if any(m is not None for m in draws.mix)
            else None)
    views = [_aug_view(mel, frames, m, r, pool)
             for m, r in zip(draws.mix, draws.rrc)]
    # valid token count per sample = full-height patches along time
    mask = make_token_mask(draws.mask, cfg.mask_ratio, cfg.mask_type,
                           cfg.mask_len, cfg.min_mask_len,
                           valid=frames // cfg.patch_w)
    return (torch.cat(views, 0), torch.cat([frames, frames], 0),
            torch.cat([mask, mask], 0))


class FrameMethod:
    """The student and teacher branches of ATST-Frame and its step.

    Parameters are drawn on the CPU from ``seed`` and moved to
    ``device``, the card unless the caller asks for the CPU (without a
    card that raises); ``plain=True`` runs every kernel's plain version
    (the reference the kernel path is held against on the card)."""

    def __init__(self, cfg: FramePretrainConfig, device="cuda", seed: int = 0,
                 plain: bool = False):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.plain = plain
        gen = torch.Generator().manual_seed(seed)
        dtype = getattr(torch, cfg.dtype)
        # drawn on the CPU, then moved to the device with the heads
        kw = dict(spec_h=cfg.mel.n_mels, spec_w=cfg.out_frames,
                  patch_h=cfg.patch_h, patch_w=cfg.patch_w, dtype=dtype,
                  plain=plain, device="cpu", pos_type=cfg.pos_type)
        hd, od = (128, 32) if cfg.arch == "tiny" else (4096, 256)
        enc = _ARCHS[cfg.arch]
        d2v = cfg.avg_blocks > 0
        self.student = Branch(
            enc(generator=gen, fused_attention=cfg.fused_attention,
                train_quant=cfg.student_quant, **kw),
            predictor=not d2v, hidden_dim=hd, out_dim=od,
            projector="linear" if d2v else "mlp")
        # the teacher is never differentiated: in bf16 the inference block
        # kernels (their stochastic depth keeps the train-mode teacher)
        self.teacher = Branch(
            enc(generator=gen, fused_infer=cfg.fused_attention,
                infer_quant=cfg.teacher_quant, avg_blocks=cfg.avg_blocks,
                **kw),
            predictor=False, hidden_dim=hd, out_dim=od,
            projector="none" if d2v else "mlp")
        with torch.no_grad():
            self.student.head.reset_parameters(gen)
        self.student.to(self.device)
        self.teacher.to(self.device).requires_grad_(False)
        self.depth = self.student.encoder.depth

    def init_state(self, seed: int = 0) -> PretrainState:
        """Teacher copied from the student, zero moments, the step's
        generator on the device seeded with ``seed``."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        return init_pretrain_state(self.student, self.teacher, gen)

    def draw(self, gen: torch.Generator, batch: int) -> StepDraws:
        """The draws of a (global) batch of ``batch`` clips."""
        return draw_step(gen, self.cfg, batch, self.depth, self.device)

    def forward_loss(self, student, teacher, batch, gen, draws=None):
        cfg = self.cfg
        wav = wav_to_f32(torch.as_tensor(batch["wav"], device=self.device))
        valid = torch.as_tensor(batch["valid"], device=self.device).long()
        B = wav.shape[0]
        if draws is None:
            draws = self.draw(gen, global_batch_size(B))
        draws = local_draws(draws, global_batch_size(B))
        mel2, frames2, mask2 = frame_train_views(wav, valid, cfg, draws,
                                                 self.plain)
        if cfg.symmetric:
            s_in, s_len, s_mask = mel2, frames2, mask2
            t_in, t_len, t_mask = mel2, frames2, mask2
        else:
            t_in, t_len, t_mask = mel2[:B], frames2[:B], mask2[:B]
            s_in, s_len, s_mask = mel2[B:], frames2[B:], mask2[B:]
        s_out, s_sel = student(s_in, s_len, mask_index=s_mask,
                               apply_mask=True, dps=draws.student_dp)
        with torch.no_grad():
            t_out, _ = teacher(t_in, t_len, mask_index=t_mask,
                               apply_mask=False, dps=draws.teacher_dp)
        ls = frame_byol_loss(s_out, t_out, s_sel, symmetric=cfg.symmetric)
        return ls.loss, {"std_frm_stu": ls.std_student.detach(),
                         "std_frm_tea": ls.std_teacher.detach()}

    def make_step(self):
        return make_pretrain_step(self.cfg.optimizer, self.forward_loss,
                                  self.plain)
