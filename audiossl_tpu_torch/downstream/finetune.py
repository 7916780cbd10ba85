"""Full finetuning of a pretrained encoder with a linear head (PyTorch port
of ``audiossl_tpu/downstream/finetune.py``).

Reference ``FineTuningPLModule`` (``methods/atst/downstream/model.py:
172-306``, the atstframe variant ``model.py:149-327``): the encoder and a
:class:`~audiossl_tpu_torch.models.heads.LinearHead` trained together with
a per-step cosine learning rate, layer-wise LR decay 0.75 over the blocks,
SGD with momentum 0.9, cross-entropy or summed sigmoid BCE on mixup's soft
targets, and the gradient clipped to a global norm of 3. JAX's
``optimizer="adamw"`` and ``weight_decay`` have no caller there (its
driver sets neither) and are not ported.

A step is JAX's line for line (:meth:`FinetuneTask.train_step`): the
central crop and the mel (K1 on the card) with no gradient, mixup by one
roll of the batch, the SpecAugment masks, RandomResizeCrop, the encoder in
training mode with drop path (the chunked clip API or the frame encoder's
scene embedding), the head with its BatchNorm statistics updated, the
loss, the clip, then the update written out over the parameters as JAX's
optax chain computes it: the momentum trace times each parameter's
layer-decay factor, times the learning rate. The optimizer is optax's in
JAX, not the fused AdamW + EMA kernel, so K7 is not on this path; the
encoder is the f32 module route, so K1 is its only kernel.

The step's random numbers are handed in (:class:`FinetuneDraws`), so a
test passes JAX's; :func:`draw_finetune` draws them from a
``torch.Generator`` and, for mixup's Beta weights (``torch.distributions``
takes no generator), a ``numpy`` generator.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from audiossl_tpu_torch.downstream.embedding import central_crop_frames
from audiossl_tpu_torch.models.atst import AudioTransformer
from audiossl_tpu_torch.models.heads import LinearHead
from audiossl_tpu_torch.models.transformer import drop_path_multipliers
from audiossl_tpu_torch.ops.melspec import MelConfig, log_melspec
from audiossl_tpu_torch.parallel.mesh import (all_reduce_sum, data_world,
                                              gather_rows, local_rows,
                                              sum_tensors)
from audiossl_tpu_torch.training.schedules import cosine_schedule
from audiossl_tpu_torch.transforms.augment import (draw_mask, freq_mask,
                                                   random_resize_crop,
                                                   time_mask)
from audiossl_tpu_torch.transforms.target import (draw_mixup_label,
                                                  mixup_spec_label)

FREQ_MASK, TIME_MASK = 10, 50  # the SpecAugment masks' widest bands
RRC_CANVAS, RRC_SCALE = (1.0, 1.5), (0.6, 1.5)  # RandomResizeCrop's
# virtual canvas, and its box's frequency and time scales (JAX's defaults)


@dataclasses.dataclass(frozen=True)
class FinetuneConfig:
    learning_rate: float = 5e-4
    max_epochs: int = 50
    steps_per_epoch: int = 100
    warmup_steps: int = 0
    momentum: float = 0.9
    layer_wise_lr: float = 0.75       # reference lr_scale; 1.0 disables
    grad_clip: float = 3.0
    multi_label: bool = False
    num_labels: int = 0
    n_blocks: int = 12
    chunk_len: int = 601
    avgpool: bool = True
    crop_len_s: float = 12.0
    mixup: bool = True
    mixup_alpha: float = 0.5
    # probability of mixing each sample (reference
    # MixupSpecLabelAudioset.mixup_ratio; 1.0 = always)
    mixup_ratio: float = 1.0
    specaug: bool = False
    rrc: bool = False  # RandomResizeCrop on the training mel
    freeze_embed: bool = False
    mel: MelConfig = MelConfig()
    sr: int = 16000
    # JAX reads the drop-path rate off its encoder (AudioTransformer's
    # drop_path_rate, 0.1 as train_freeze.load_encoder builds it); the
    # port's encoder holds none
    drop_path_rate: float = 0.1

    @property
    def max_steps(self):
        return self.max_epochs * self.steps_per_epoch


@dataclasses.dataclass
class FinetuneState:
    """The encoder and head (trained in place), the momentum trace by
    parameter name (``mu``) and the step."""
    step: int
    encoder: AudioTransformer
    head: LinearHead
    mu: Dict[str, torch.Tensor]

    @property
    def params(self) -> Dict[str, torch.nn.Parameter]:
        return named_params(self.encoder, self.head)


@dataclasses.dataclass
class FinetuneDraws:
    """One step's random numbers. ``lam`` [B]: mixup's Beta(alpha, alpha)
    weights; ``keep`` [B]: uniforms, a sample with ``keep >= mixup_ratio``
    is not mixed; ``shift``: the roll of the batch that picks the partners;
    ``freq``, ``time``: each mask's (widths [B], start uniforms [B]);
    ``rrc``: RandomResizeCrop's (height, row, width, column) uniforms [B];
    ``dp``: drop-path uniforms [depth, 2, rows], rows the encoder's
    sequences (B, or B * chunks for the chunked clip API). None where the
    configuration does not read them."""
    lam: Optional[torch.Tensor] = None
    keep: Optional[torch.Tensor] = None
    shift: int = 1
    freq: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
    time: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
    rrc: Optional[Tuple[torch.Tensor, ...]] = None
    dp: Optional[torch.Tensor] = None


def named_params(encoder, head) -> Dict[str, torch.nn.Parameter]:
    """The parameters a step trains, ``encoder.<name>`` then
    ``head.<name>``."""
    out = {f"encoder.{k}": p for k, p in encoder.named_parameters()}
    out.update((f"head.{k}", p) for k, p in head.named_parameters())
    return out


_EMBED_KEYS = ("patch_embed", "pos_embed", "cls_token", "mask_embed")


def layer_decay_factors(names, depth: int, decay: float,
                        freeze_embed: bool = False) -> Dict[str, float]:
    """Per-parameter LR multipliers over the encoder's parameter names, as
    JAX's ``layer_decay_factors`` over its param tree (reference
    ``layer_wise_lr_groups``, ``methods/atst/downstream/model.py:
    129-169``): block i ``decay**(depth - i)``; the patch, position, CLS
    and mask embeddings ``decay**depth``, or 0.0 with
    ``freeze_embed`` (the blocks keep training); the final norm (``norm``
    / ``norm_frame``) ``decay``; any other name (the head's) 1.0."""
    def factor(name):
        m = re.match(r"blocks\.(\d+)\.", name)
        if m:
            return decay ** (depth - int(m.group(1)))
        first = name.split(".")[0]
        if first in _EMBED_KEYS:
            return 0.0 if freeze_embed else decay ** depth
        if first in ("norm", "norm_frame"):
            return decay
        return 1.0

    return {k: factor(k) for k in names}


def draw_finetune(cfg: FinetuneConfig, batch: int, rows: int, depth: int,
                  gen: torch.Generator, rng: np.random.Generator,
                  device="cpu") -> FinetuneDraws:
    """The draws :meth:`FinetuneTask.train_step` reads under ``cfg``, from
    ``gen`` (a CPU generator) and, for mixup's weights, ``rng``; moved to
    ``device``."""
    d = FinetuneDraws()
    if cfg.mixup:
        d.lam, d.shift = draw_mixup_label(rng, gen, batch, cfg.mixup_alpha)
        if cfg.mixup_ratio < 1.0:
            d.keep = torch.rand(batch, generator=gen)
    if cfg.specaug:
        d.freq = draw_mask(gen, batch, FREQ_MASK, "cpu")
        d.time = draw_mask(gen, batch, TIME_MASK, "cpu")
    if cfg.rrc:
        d.rrc = tuple(torch.rand(batch, generator=gen) for _ in range(4))
    if cfg.drop_path_rate > 0:
        d.dp = torch.rand(depth, 2, rows, generator=gen)
    return draws_to(d, device)


def draws_to(d: FinetuneDraws, device) -> FinetuneDraws:
    """``d`` with its tensors on ``device``."""
    def to(v):
        if isinstance(v, torch.Tensor):
            return v.to(device)
        if isinstance(v, tuple):
            return tuple(to(x) for x in v)
        return v

    return FinetuneDraws(**{f.name: to(getattr(d, f.name))
                            for f in dataclasses.fields(d)})


def local_draws(d: FinetuneDraws, batch: int) -> FinetuneDraws:
    """This rank's rows of the draws ``d`` of a global batch of ``batch``
    clips (``parallel.local_rows``): each clip's own draws, and of the
    drop-path uniforms the sequences of its clips, clip-major as
    ``get_intermediate_layers_chunks`` lays them out. The shift is the
    global batch's."""
    sl = local_rows(batch)
    if sl == slice(0, batch):
        return d

    def rows(v):
        if isinstance(v, tuple):
            return tuple(rows(x) for x in v)
        return None if v is None else v[sl]

    out = dataclasses.replace(d, lam=rows(d.lam), keep=rows(d.keep),
                              freq=rows(d.freq), time=rows(d.time),
                              rrc=rows(d.rrc))
    if d.dp is not None:
        per = d.dp.shape[-1] // batch  # sequences a clip
        out.dp = d.dp[..., sl.start * per:sl.stop * per]
    return out


def _f32(v: float) -> float:
    return float(np.float32(v))


class FinetuneTask:
    """The encoder and a LinearHead trained together (JAX's
    ``FinetuneTask``). The head's weight is drawn from ``generator`` (seed
    0 when None); both modules live on the encoder's device."""

    def __init__(self, encoder: AudioTransformer, cfg: FinetuneConfig,
                 embed_dim: int, generator: Optional[torch.Generator] = None):
        self.encoder = encoder
        self.cfg = cfg
        self.device = encoder.pos_embed.device
        self.head = LinearHead(embed_dim, cfg.num_labels, device=self.device,
                               generator=generator)
        self.lr_sched = cosine_schedule(cfg.learning_rate, 1e-6,
                                        cfg.max_steps, cfg.warmup_steps)
        # by the step's parameter names; JAX multiplies only when a factor
        # can differ from 1
        self.factors = None
        if cfg.layer_wise_lr < 1.0 or cfg.freeze_embed:
            enc = layer_decay_factors(
                [k for k, _ in encoder.named_parameters()], encoder.depth,
                cfg.layer_wise_lr, cfg.freeze_embed)
            self.factors = {k: enc.get(k[len("encoder."):], 1.0)
                            for k in named_params(encoder, self.head)}

    def init_state(self) -> FinetuneState:
        """Step 0 with a zero momentum trace; the encoder and head put in
        training mode with gradients on."""
        self.encoder.requires_grad_(True).train()
        self.head.requires_grad_(True).train()
        mu = {k: torch.zeros_like(p)
              for k, p in named_params(self.encoder, self.head).items()}
        return FinetuneState(step=0, encoder=self.encoder, head=self.head,
                             mu=mu)

    def rows(self, batch: int, samples: int) -> int:
        """The sequences the encoder runs for ``batch`` clips of
        ``samples`` samples (the drop-path draws' last axis)."""
        if not self.encoder.use_cls:
            return batch
        width = min(int(self.cfg.crop_len_s * self.cfg.sr), samples)
        frames = self.cfg.mel.num_frames(width)
        return batch * (frames // self.cfg.chunk_len + 1)

    def _batch(self, batch):
        dev = self.device
        wav = torch.as_tensor(np.asarray(batch["wav"]), device=dev).float()
        valid = torch.as_tensor(np.asarray(batch["valid"]), device=dev).long()
        return wav, valid

    def _features(self, wav, valid):
        """The central crop and its mel [B, F, T] with its frame counts."""
        cfg = self.cfg
        crop, cv = central_crop_frames(wav, valid,
                                       int(cfg.crop_len_s * cfg.sr))
        spec = log_melspec(crop, cv, cfg.mel)
        return spec, cv // cfg.mel.hop_length + 1

    def _encode(self, spec, frames, dps=None):
        cfg = self.cfg
        if self.encoder.use_cls:
            return self.encoder.get_intermediate_layers_chunks(
                spec, frames, n=cfg.n_blocks, chunk_len=cfg.chunk_len,
                avgpool=cfg.avgpool, dps=dps)
        return self.encoder.get_intermediate_layers(
            spec, frames, n=cfg.n_blocks, scene=True, dps=dps)

    def train_step(self, state: FinetuneState, batch,
                   draws: FinetuneDraws) -> Tuple[FinetuneState, dict]:
        """One step on ``batch`` (``wav`` [B, L], ``valid`` [B], ``label``
        [B] or [B, C]) with ``draws``; updates the state in place and
        returns it with ``loss``, ``lr`` and ``gnorm``.

        Under a process group ``batch`` is this rank's rows of the global
        batch (``parallel.shard_batch``) and ``draws`` the global batch's
        (:func:`local_draws` takes the rank's): mixup's partners come
        from every rank, the loss is the global mean, the gradients are
        summed over ranks before the norm that clips them, and the head's
        BatchNorm takes the global statistics, as one process computes
        them."""
        cfg = self.cfg
        lr = _f32(self.lr_sched(state.step))  # JAX's schedule runs in f32
        wav, valid = self._batch(batch)
        n_global = len(wav) * data_world().size
        draws = local_draws(draws, n_global)
        y = torch.as_tensor(np.asarray(batch["label"]), device=self.device)
        with torch.no_grad():
            spec, frames = self._features(wav, valid)
            y_soft = (y.float() if cfg.multi_label
                      else F.one_hot(y.long(), cfg.num_labels).float())
            if cfg.mixup:
                lam = draws.lam.float()
                if cfg.mixup_ratio < 1.0:
                    lam = torch.where(draws.keep >= cfg.mixup_ratio, 1.0, lam)
                spec, y_soft = mixup_spec_label(spec, y_soft, lam,
                                                draws.shift)
            if cfg.specaug:
                spec = freq_mask(spec, *draws.freq)
                spec = time_mask(spec, *draws.time, valid_frames=frames)
            if cfg.rrc:
                h, iy, w, ix = draws.rrc
                spec = random_resize_crop(
                    spec, h, iy, w, ix, virtual_crop_scale=RRC_CANVAS,
                    freq_scale=RRC_SCALE, time_scale=RRC_SCALE,
                    valid_frames=frames)
        dps = (None if cfg.drop_path_rate == 0 else
               drop_path_multipliers(draws.dp, cfg.drop_path_rate))
        logits = self.head(self._encode(spec, frames, dps))
        if cfg.multi_label:  # optax's sigmoid BCE, summed over labels
            per_clip = F.binary_cross_entropy_with_logits(
                logits, y_soft, reduction="none").sum(-1)
        else:
            per_clip = -(y_soft * F.log_softmax(logits, -1)).sum(-1)
        # this rank's share of the global batch's mean
        loss = per_clip.sum() / n_global if n_global != len(wav) else \
            per_clip.mean()
        params = state.params
        grads = torch.autograd.grad(loss, list(params.values()),
                                    allow_unused=True)
        with torch.no_grad():
            # a parameter the loss does not reach (the clip encoder's
            # mask_embed) has a zero gradient, as in JAX
            grads = [torch.zeros_like(p) if g is None else g
                     for p, g in zip(params.values(), grads)]
            sum_tensors(grads)
            gnorm = torch.sqrt(sum((g * g).sum() for g in grads))
            scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-6), max=1.0)
            self._update(state, params, [g * scale for g in grads], lr)
            loss = all_reduce_sum(loss.detach())
        state.step += 1
        return state, {"loss": loss, "lr": lr, "gnorm": gnorm}

    def _update(self, state, params, grads, lr: float):
        """JAX's chain: ``optax.trace`` (trace = g + momentum * trace),
        times the layer-decay factor, then ``p -= lr * u``."""
        for (name, p), g in zip(params.items(), grads):
            u = state.mu[name].mul_(self.cfg.momentum).add_(g).clone()
            if self.factors is not None:
                u.mul_(self.factors[name])
            p.sub_(u * lr)

    def eval_all(self, state: FinetuneState, batch) -> torch.Tensor:
        """:meth:`eval_logits` of a batch every rank holds whole, the same
        on every rank: each rank runs its rows and they are gathered
        (``parallel.gather_rows``; eval is row-independent)."""
        return gather_rows(lambda rows: self.eval_logits(state, rows), batch)

    @torch.no_grad()
    def eval_logits(self, state: FinetuneState, batch) -> torch.Tensor:
        """Logits [B, num_labels] of ``batch``: no drop path, the head's
        BatchNorm on its running statistics."""
        spec, frames = self._features(*self._batch(batch))
        state.head.eval()
        try:
            return state.head(self._encode(spec, frames))
        finally:
            state.head.train()
