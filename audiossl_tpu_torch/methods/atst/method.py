"""ATST-Clip pretraining, end to end on the device (PyTorch port of
``audiossl_tpu/methods/atst/method.py``).

Per view of each clip: a crop of random length (``sample_crop_lengths``)
at a random start, its mel, mixup with an in-batch partner and
RandomResizeCrop on a virtual canvas; the two views are stacked
view-major ([2B, F, T]). With ``different_positive=False`` the second view
is another augmentation of the first view's crop. The student (encoder +
projector + predictor) and the teacher (encoder + projector) embed the CLS
token of every view, the loss is the cross-view clip BYOL loss, and the
teacher follows the student by EMA (``training/pretrain.py``).

Every random number of a step comes from :func:`draw_step` (a
``torch.Generator`` on the device) as a :class:`ClipStepDraws`, and the
rest of the step is a function of those draws, so a caller (the tests) can
hand in other draws, such as the JAX package's.

Under a process group every rank draws the global batch's numbers and
takes its rows (:func:`local_draws`), mixup's partners come from the
global batch and the BatchNorms and the loss reduce over it, as in
ATST-Frame (``methods/atstframe/method.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from audiossl_tpu_torch.kernels.build import resolve_device
from audiossl_tpu_torch.models.atst import ast_base, ast_small, ast_tiny
from audiossl_tpu_torch.models.byol import clip_byol_loss
from audiossl_tpu_torch.models.transformer import drop_path_multipliers
from audiossl_tpu_torch.ops.melspec import MelConfig, log_melspec
from audiossl_tpu_torch.parallel.mesh import (global_batch_size, local_rows,
                                              world)
from audiossl_tpu_torch.training.pretrain import (Branch, OptimizerConfig,
                                                  PretrainState,
                                                  init_pretrain_state,
                                                  make_pretrain_step)
from audiossl_tpu_torch.transforms.augment import (draw_crop, draw_mixup,
                                                   draw_resize_crop,
                                                   mixup_log, random_crop_wav,
                                                   random_resize_crop, rows_of,
                                                   sample_crop_lengths,
                                                   view_major_rows, wav_to_f32)

_ARCHS = {"tiny": ast_tiny, "small": ast_small, "base": ast_base}


@dataclasses.dataclass(frozen=True)
class ClipPretrainConfig:
    """The JAX package's ``ClipPretrainConfig`` (defaults = the published
    recipe, reference methods/atst/train_small.sh), plus the encoders'
    ``drop_path_rate`` (the JAX encoders' default, 0.1)."""
    arch: str = "small"
    sr: int = 16000
    anchor_len: Tuple[float, float] = (6.0, 6.0)
    positive_len: Tuple[float, float] = (6.0, 6.0)
    different_positive: bool = True
    virtual_crop: float = 1.5
    mixup_ratio: float = 0.4
    optimizer: OptimizerConfig = OptimizerConfig()
    mel: MelConfig = MelConfig(stft_precision="default")
    dtype: str = "float32"
    # the kernels: in f32 K6 and LayerNormPG (K8) for both encoders, in
    # bf16 K4/K5 for the student and K2/K3 for the teacher; False runs the
    # module path
    fused_attention: bool = True
    drop_path_rate: float = 0.1
    # opt-in int8 recipes on the bf16 block-kernel route, as in
    # FramePretrainConfig: the teacher's products ("int8"), the student's
    # forward ("int8") and grad-to-input ("int8dx") products
    teacher_quant: str = "none"
    student_quant: str = "none"

    @property
    def max_len_s(self) -> float:
        return max(self.anchor_len + self.positive_len)

    @property
    def out_frames(self) -> int:
        """Mel width of every view: the longest crop's frames."""
        return int(self.max_len_s * self.sr) // self.mel.hop_length + 1

    @property
    def out_samples(self) -> int:
        return int(self.max_len_s * self.sr)


@dataclasses.dataclass
class ViewDraws:
    """The random numbers of one view: crop-length uniforms [B] (None for
    a fixed length), crop-start uniforms [B], mixup (a [B], shift [B]) and
    RandomResizeCrop uniforms (h, iy, w, ix), each [B]. ``crop_len`` and
    ``crop`` are None for a view that shares the first view's crop."""
    crop_len: Optional[torch.Tensor]
    crop: Optional[torch.Tensor]
    mix: Tuple[torch.Tensor, torch.Tensor]
    rrc: Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


@dataclasses.dataclass
class ClipStepDraws:
    """Every random number of one step: the two views' draws and the
    drop-path keep multipliers [depth, 2, 2B] of each encoder (None
    without stochastic depth)."""
    views: Tuple[ViewDraws, ViewDraws]
    student_dp: Optional[torch.Tensor]
    teacher_dp: Optional[torch.Tensor]


def draw_step(gen: torch.Generator, cfg: ClipPretrainConfig, batch: int,
              depth: int, device) -> ClipStepDraws:
    """Draw a step's random numbers from ``gen`` on ``device``."""
    views = []
    for i, (lo, hi) in enumerate((cfg.anchor_len, cfg.positive_len)):
        own_crop = i == 0 or cfg.different_positive
        crop_len = (torch.rand(batch, generator=gen, device=device)
                    if own_crop and lo != hi else None)
        views.append(ViewDraws(
            crop_len=crop_len,
            crop=draw_crop(gen, batch, device) if own_crop else None,
            mix=draw_mixup(gen, batch, cfg.mixup_ratio, device),
            rrc=draw_resize_crop(gen, batch, device, time=True)))
    dps = [None, None]
    if cfg.drop_path_rate > 0.0:
        dps = [drop_path_multipliers(
            torch.rand(depth, 2, 2 * batch, generator=gen, device=device),
            cfg.drop_path_rate) for _ in range(2)]
    return ClipStepDraws(views=tuple(views), student_dp=dps[0],
                         teacher_dp=dps[1])


def local_draws(draws: ClipStepDraws, batch: int) -> ClipStepDraws:
    """This rank's rows of the draws of a global batch of ``batch``: each
    view's per-clip draws, and the drop-path multipliers' rows of each
    view (view-major). The draws themselves in one process."""
    if world().size == 1:
        return draws
    sl = local_rows(batch)
    views = tuple(ViewDraws(crop_len=rows_of(v.crop_len, sl),
                            crop=rows_of(v.crop, sl), mix=rows_of(v.mix, sl),
                            rrc=rows_of(v.rrc, sl)) for v in draws.views)
    return ClipStepDraws(
        views=views, student_dp=view_major_rows(draws.student_dp, batch, sl),
        teacher_dp=view_major_rows(draws.teacher_dp, batch, sl))


def _crop_mel(wav, valid, len_range, cfg: ClipPretrainConfig,
              draws: ViewDraws, plain: bool):
    """waveforms [B, L] -> (un-augmented mel crop [B, n_mels, out_frames],
    its frame counts [B])."""
    B = wav.shape[0]
    crop_len = sample_crop_lengths(draws.crop_len, B, len_range[0],
                                   len_range[1], cfg.sr, wav.device)
    crops, crop_valid = random_crop_wav(wav, valid, crop_len,
                                        cfg.out_samples, draws.crop)
    mel = log_melspec(crops, crop_valid, cfg.mel, plain=plain)
    return mel, crop_valid // cfg.mel.hop_length + 1


def _augment_view(mel, frames, cfg: ClipPretrainConfig, draws: ViewDraws):
    """Mixup, then RandomResizeCrop on a (1, virtual_crop) canvas
    (reference positive_transform1/2, methods/atst/transform.py:34-45)."""
    mel = mixup_log(mel, *draws.mix, valid_frames=frames)
    return random_resize_crop(
        mel, *draws.rrc, virtual_crop_scale=(1.0, cfg.virtual_crop),
        freq_scale=(0.6, 1.5), time_scale=(0.6, 1.5), valid_frames=frames)


def clip_train_views(wav, valid, cfg: ClipPretrainConfig,
                     draws: ClipStepDraws, plain: bool = False):
    """waveforms [B, L] -> (views [2B, F, T] stacked view-major, frame
    counts [2B]); with ``different_positive=False`` the second view
    augments the first view's crop (reference transform.py:50-74)."""
    d1, d2 = draws.views
    mel1, f1 = _crop_mel(wav, valid, cfg.anchor_len, cfg, d1, plain)
    if cfg.different_positive:
        mel2, f2 = _crop_mel(wav, valid, cfg.positive_len, cfg, d2, plain)
    else:
        mel2, f2 = mel1, f1
    views = [_augment_view(mel1, f1, cfg, d1), _augment_view(mel2, f2, cfg, d2)]
    return torch.cat(views, 0), torch.cat([f1, f2], 0)


class ClipMethod:
    """The student and teacher branches of ATST-Clip and its step.

    Parameters are drawn on the CPU from ``seed`` and moved to
    ``device``, the card unless the caller asks for the CPU (without a
    card that raises); ``plain=True`` runs every kernel's plain version
    (the reference the kernel path is held against on the card)."""

    def __init__(self, cfg: ClipPretrainConfig, device="cuda", seed: int = 0,
                 plain: bool = False):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.plain = plain
        gen = torch.Generator().manual_seed(seed)
        # drawn on the CPU, then moved to the device with the heads
        kw = dict(spec_h=cfg.mel.n_mels, spec_w=cfg.out_frames,
                  dtype=getattr(torch, cfg.dtype), plain=plain, device="cpu")
        hd, od = (128, 32) if cfg.arch == "tiny" else (4096, 256)
        enc = _ARCHS[cfg.arch]
        self.student = Branch(
            enc(generator=gen, fused_attention=cfg.fused_attention,
                train_quant=cfg.student_quant, **kw),
            predictor=True, hidden_dim=hd, out_dim=od)
        # the teacher is never differentiated: in bf16 the inference block
        # kernels (their stochastic depth keeps the train-mode teacher)
        self.teacher = Branch(
            enc(generator=gen, fused_infer=cfg.fused_attention,
                infer_quant=cfg.teacher_quant, **kw),
            predictor=False, hidden_dim=hd, out_dim=od)
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

    def draw(self, gen: torch.Generator, batch: int) -> ClipStepDraws:
        """The draws of a (global) batch of ``batch`` clips."""
        return draw_step(gen, self.cfg, batch, self.depth, self.device)

    def forward_loss(self, student, teacher, batch, gen, draws=None):
        wav = wav_to_f32(torch.as_tensor(batch["wav"], device=self.device))
        valid = torch.as_tensor(batch["valid"], device=self.device).long()
        batch_size = global_batch_size(wav.shape[0])
        if draws is None:
            draws = self.draw(gen, batch_size)
        draws = local_draws(draws, batch_size)
        mel, frames = clip_train_views(wav, valid, self.cfg, draws,
                                       self.plain)
        s_out = student(mel, frames, dps=draws.student_dp)
        # the reference teacher runs in train mode too (stochastic depth,
        # BatchNorm batch statistics)
        with torch.no_grad():
            t_out = teacher(mel, frames, dps=draws.teacher_dp)
        ls = clip_byol_loss(s_out, t_out, ncrops=2)
        return ls.loss, {"std_cls_s": ls.std_student.detach(),
                         "std_cls_t": ls.std_teacher.detach()}

    def make_step(self):
        return make_pretrain_step(self.cfg.optimizer, self.forward_loss,
                                  self.plain)
