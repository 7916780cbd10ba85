"""ATST-C2F distillation (PyTorch port of ``audiossl_tpu/methods/distill/
method.py``; reference ``methods/atstframe/module_distill.py:131-406`` and
``module_distill_other.py``).

A frozen, finetuned ATST-Clip classifier (the clip encoder, its chunked CLS
and mean features, a :class:`~audiossl_tpu_torch.models.heads.LinearHead`)
teaches an ATST-Frame student with a LinearHead of its own: loss =
``lambda_d`` * distance to the teacher's targets + (1 - ``lambda_d``) *
loss on the labels, with sigmoid BCE to the teacher's sigmoid (multi-label)
or cross-entropy to its softmax (single-label), the gradient clipped to a
global norm, and SGD with momentum and layer-wise LR decay.

A step is JAX's line for line (:meth:`DistillMethod.train_step`): a random
crop (AudioSet) or a central crop (the registered sets), the mel (K1 on the
card) shared by teacher and student, the teacher with no gradient, the
student's chunked scene embedding with drop path, the student head with its
BatchNorm statistics updated, the loss, the clip, then ``optax.trace``'s
momentum times each parameter's layer-decay factor, times the learning
rate. Both encoders run the f32 module route, so K1 is the path's only
kernel.

The step's random numbers (the crop starts, the drop-path uniforms) are
handed in (:class:`DistillDraws`), so a test passes JAX's;
:meth:`DistillMethod.draw` draws them from the state's host
``torch.Generator``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from audiossl_tpu_torch.downstream.embedding import central_crop_frames
from audiossl_tpu_torch.downstream.finetune import (layer_decay_factors,
                                                    momentum_update,
                                                    named_params)
from audiossl_tpu_torch.models.atst import AudioTransformer
from audiossl_tpu_torch.models.heads import LinearHead
from audiossl_tpu_torch.models.transformer import drop_path_multipliers
from audiossl_tpu_torch.ops.melspec import MelConfig, log_melspec
from audiossl_tpu_torch.parallel.mesh import (all_reduce_sum, data_world,
                                              gather_rows, local_rows,
                                              sum_tensors)
from audiossl_tpu_torch.training.schedules import cosine_schedule
from audiossl_tpu_torch.transforms.augment import random_crop_wav


@dataclasses.dataclass(frozen=True)
class DistillConfig:
    arch: str = "base"
    num_labels: int = 527
    lambda_d: float = 1.0
    learning_rate: float = 1e-1
    max_epochs: int = 40
    steps_per_epoch: int = 1000
    warmup_epochs: int = 2
    momentum: float = 0.9
    layer_wise_lr: float = 0.75
    freeze_embed: bool = False
    grad_clip: float = 3.0     # reference gradient_clip_val=3.0
    chunk_len: int = 601  # the teacher's chunk (frames)
    max_len: float = 10.0
    sr: int = 16000
    mel: MelConfig = MelConfig()
    # single-label tasks (module_distill_other.py): cross-entropy losses
    # and a central crop instead of AudioSet's random 10 s crop
    multi_label: bool = True
    crop: str = "random"       # "random" | "central"
    # both encoders are built at the pretraining width (frames); longer
    # inputs are chunked
    pretrain_frames: int = 1001
    # the student's chunk (module_distill_other.py:187; a 10 s AudioSet
    # crop is one chunk)
    student_chunk_len: int = 1001
    # JAX reads the student's drop-path rate off its encoder (the maker's
    # default, 0.1); the port's encoder holds none
    drop_path_rate: float = 0.1

    @property
    def out_samples(self):
        return int(self.max_len * self.sr)

    @property
    def out_frames(self):
        return self.out_samples // self.mel.hop_length + 1

    @property
    def max_steps(self):
        return self.max_epochs * self.steps_per_epoch


@dataclasses.dataclass
class DistillState:
    """The student encoder and head (trained in place), the momentum trace
    by parameter name (``mu``), the step and the generator the step's draws
    come from."""
    step: int
    encoder: AudioTransformer
    head: LinearHead
    mu: Dict[str, torch.Tensor]
    generator: torch.Generator

    @property
    def params(self) -> Dict[str, torch.nn.Parameter]:
        return named_params(self.encoder, self.head)


@dataclasses.dataclass
class DistillDraws:
    """One step's random numbers: ``crop`` [B] the crop-start uniforms
    (a random crop), ``dp`` [depth, 2, B * chunks] the student's drop-path
    uniforms, clip-major; None where the configuration reads none."""
    crop: Optional[torch.Tensor] = None
    dp: Optional[torch.Tensor] = None

    def to(self, device) -> "DistillDraws":
        return DistillDraws(*(None if v is None else v.to(device)
                              for v in (self.crop, self.dp)))

    def local(self, batch: int) -> "DistillDraws":
        """This rank's rows of the draws of a global batch of ``batch``
        clips (``parallel.local_rows``): its clips' crop uniforms and the
        drop-path uniforms of their chunks."""
        sl = local_rows(batch)
        if sl == slice(0, batch):
            return self
        dp = self.dp
        if dp is not None:
            per = dp.shape[-1] // batch  # chunks a clip
            dp = dp[..., sl.start * per:sl.stop * per]
        return DistillDraws(None if self.crop is None else self.crop[sl], dp)


def host_state(state: DistillState, copy: bool = True) -> Optional[dict]:
    """A host copy of ``state`` for ``training.checkpoint.
    CheckpointManager``: the step, ``student`` (``encoder.*`` and
    ``head.*``, BatchNorm statistics included), the momentum trace and the
    generator's state; None with ``copy=False`` (a rank that writes
    nothing). ``compat.checkpoint.load_pretrain_checkpoint(path,
    which="student")`` reads the encoder back."""
    if not copy:
        return None
    return {"step": int(state.step), "student": student_state(state),
            "mu": {k: _host(v) for k, v in state.mu.items()},
            "generator": state.generator.get_state()}


def student_state(state: DistillState) -> Dict[str, torch.Tensor]:
    """A host copy of the student: ``encoder.*`` and ``head.*``."""
    out = {f"encoder.{k}": _host(v)
           for k, v in state.encoder.state_dict().items()}
    out.update((f"head.{k}", _host(v))
               for k, v in state.head.state_dict().items())
    return out


def _host(t: torch.Tensor) -> torch.Tensor:
    return t.detach().to("cpu", copy=True)


def _f32(v: float) -> float:
    return float(np.float32(v))


class DistillMethod:
    """The frozen teacher (``teacher``, a clip encoder, and ``t_head``, its
    LinearHead) and the student (``student``, a frame encoder, and a
    LinearHead whose weight is drawn from ``generator``, seed 0 when None).
    The student's head lives on its encoder's device."""

    def __init__(self, cfg: DistillConfig, teacher: AudioTransformer,
                 t_head: LinearHead, student: AudioTransformer,
                 generator: Optional[torch.Generator] = None):
        if t_head.linear.out_features != cfg.num_labels:
            raise ValueError(f"the teacher's head has "
                             f"{t_head.linear.out_features} labels, the "
                             f"configuration {cfg.num_labels}")
        self.cfg = cfg
        self.teacher = teacher.requires_grad_(False).eval()
        self.t_head = t_head.requires_grad_(False).eval()
        self.student = student
        self.device = student.pos_embed.device
        self.head = LinearHead(student.embed_dim, cfg.num_labels,
                               device=self.device, generator=generator)
        self.lr_sched = cosine_schedule(
            cfg.learning_rate, 1e-6, cfg.max_steps,
            cfg.warmup_epochs * cfg.steps_per_epoch)
        # the reference's layer-wise LR groups; the head's factor is 1
        enc = layer_decay_factors(
            [k for k, _ in student.named_parameters()], student.depth,
            cfg.layer_wise_lr, cfg.freeze_embed)
        self.factors = {k: enc[k[len("encoder."):]] if
                        k.startswith("encoder.") else 1.0
                        for k in named_params(student, self.head)}

    def init_state(self, generator: Optional[torch.Generator] = None
                   ) -> DistillState:
        """Step 0 with a zero momentum trace; the student and its head put
        in training mode with gradients on; ``generator`` (seed 0 when
        None) draws the steps' random numbers."""
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.student.requires_grad_(True).train()
        self.head.requires_grad_(True).train()
        mu = {k: torch.zeros_like(p)
              for k, p in named_params(self.student, self.head).items()}
        return DistillState(step=0, encoder=self.student, head=self.head,
                            mu=mu, generator=generator)

    def chunk_len(self, frames: int) -> int:
        """The student's chunk for a mel of ``frames`` frames: never wider
        than the input or the encoder's position table."""
        return min(self.cfg.student_chunk_len, self.student.spec_w, frames)

    def draw(self, state: DistillState, batch: int,
             samples: int) -> DistillDraws:
        """The draws of a step on ``batch`` clips of ``samples`` samples,
        from the state's generator, on the student's device: the crop
        uniforms [B] (a random crop) and the drop-path uniforms
        [depth, 2, B * chunks] (a positive rate)."""
        cfg = self.cfg
        gen = state.generator
        d = DistillDraws()
        if cfg.crop == "random":
            d.crop = torch.rand(batch, generator=gen)
        if cfg.drop_path_rate > 0:
            t = cfg.mel.num_frames(min(cfg.out_samples, samples))
            nc = -(-t // self.chunk_len(t))
            d.dp = torch.rand(self.student.depth, 2, batch * nc,
                              generator=gen)
        return d.to(self.device)

    def _batch(self, batch):
        dev = self.device
        wav = torch.as_tensor(np.asarray(batch["wav"]), device=dev).float()
        valid = torch.as_tensor(np.asarray(batch["valid"]), device=dev).long()
        return wav, valid

    def _features(self, wav, valid, crop_u=None):
        """The crop (random with the uniforms ``crop_u``, else central)
        and its mel [B, F, T] with its frame counts."""
        cfg = self.cfg
        if crop_u is not None:
            full = torch.full_like(valid, cfg.out_samples)
            crop, cv = random_crop_wav(wav, valid, full, cfg.out_samples,
                                       u=crop_u)
        else:
            crop, cv = central_crop_frames(wav, valid, cfg.out_samples)
        return log_melspec(crop, cv, cfg.mel), cv // cfg.mel.hop_length + 1

    @torch.no_grad()
    def teacher_logits(self, mel: torch.Tensor,
                       frames: torch.Tensor) -> torch.Tensor:
        """The teacher's logits [B, num_labels]: the clip encoder's chunked
        CLS and mean of the last block (``get_intermediate_layers_chunks``,
        chunks of ``chunk_len``), then its head on its running
        statistics."""
        feats = self.teacher.get_intermediate_layers_chunks(
            mel, frames, n=1, chunk_len=self.cfg.chunk_len, avgpool=True)
        return self.t_head(feats)

    def student_scene(self, mel: torch.Tensor, frames: torch.Tensor,
                      dps: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The student's chunked scene embedding [B, D] (JAX's
        ``_student_scene``; module_distill_other.py:183-212): the mel cut
        into ``ceil(T / chunk_len)`` chunks, each chunk's frame count
        clamped to ``[0, chunk_len]``, all encoded in one batch by the
        frame encoder's scene embedding, then averaged over the chunks a
        clip marks (the first when it holds a frame, a later one when it
        holds more than ``chunk_len // 2``). These are not the clip
        encoder's chunking rules (``get_intermediate_layers_chunks``).
        ``dps`` [depth, 2, B * chunks]: drop-path keep multipliers,
        clip-major, or None."""
        B, nf, T = mel.shape
        chunk_len = self.chunk_len(T)
        nc = max(-(-T // chunk_len), 1)
        melp = F.pad(mel, (0, nc * chunk_len - T))
        chunks = melp.reshape(B, nf, nc, chunk_len).permute(0, 2, 1, 3)
        ks = torch.arange(nc, device=mel.device)
        cur = torch.clamp(frames[:, None] - ks[None, :] * chunk_len, 0,
                          chunk_len)
        mark = torch.where(ks[None, :] == 0, cur > 0,
                           cur > chunk_len // 2).float()
        emb = self.student.get_intermediate_layers(
            chunks.reshape(B * nc, nf, chunk_len), cur.reshape(-1), n=1,
            scene=True, dps=dps).reshape(B, nc, -1)
        return (mark[..., None] * emb).sum(1) / torch.clamp(
            mark.sum(1, keepdim=True), min=1e-6)

    def train_step(self, state: DistillState, batch,
                   draws: DistillDraws):
        """One step on ``batch`` (``wav`` [B, L], ``valid`` [B], ``label``
        [B, C] multi-hot or [B] class indices) with ``draws``; updates the
        state in place and returns it with ``loss``, ``loss_d``,
        ``loss_c``, ``lr`` and ``gnorm``.

        Under a process group ``batch`` is this rank's rows of the global
        batch (``parallel.shard_batch``) and ``draws`` the global batch's
        (this rank's rows are taken here): the teacher runs on the rank's
        rows (its head on running statistics, so row-independent), each
        loss is the rank's sum over the global count (B_global * C for the
        BCE, B_global for the cross-entropy), the gradients are summed over
        ranks before the norm that clips them, the student head's
        BatchNorm takes the global statistics and the logged losses are
        global, as one process computes them."""
        cfg = self.cfg
        lr = _f32(self.lr_sched(state.step))  # JAX's schedule runs in f32
        wav, valid = self._batch(batch)
        n_global = len(wav) * data_world().size
        draws = draws.local(n_global)
        y = torch.as_tensor(np.asarray(batch["label"]), device=self.device)
        with torch.no_grad():
            mel, frames = self._features(
                wav, valid, draws.crop if cfg.crop == "random" else None)
            t_logits = self.teacher_logits(mel, frames)
            if cfg.multi_label:
                target = torch.sigmoid(t_logits)
                y_soft = y.float()
            else:
                # the reference's single-label distillation: cross-entropy
                # to the teacher's softmax and to the hard label
                # (module_distill_other.py:315-324)
                target = torch.softmax(t_logits, -1)
                y_soft = F.one_hot(y.long(), cfg.num_labels).float()
        dps = (None if cfg.drop_path_rate == 0 or draws.dp is None else
               drop_path_multipliers(draws.dp, cfg.drop_path_rate))
        logits = state.head(self.student_scene(mel, frames, dps))

        def mean(per):  # this rank's share of the global batch's mean
            if n_global == len(wav):
                return per.mean()
            return per.sum() / (n_global * per[0].numel())

        if cfg.multi_label:  # optax's sigmoid BCE, meaned over B x C
            loss_d, loss_c = (mean(F.binary_cross_entropy_with_logits(
                logits, t, reduction="none")) for t in (target, y_soft))
        else:
            logp = F.log_softmax(logits, -1)
            loss_d, loss_c = (mean(-(t * logp).sum(-1))
                              for t in (target, y_soft))
        loss = cfg.lambda_d * loss_d + (1 - cfg.lambda_d) * loss_c
        params = state.params
        grads = torch.autograd.grad(loss, list(params.values()),
                                    allow_unused=True)
        with torch.no_grad():
            # a parameter the loss does not reach (mask_embed) has a zero
            # gradient, as in JAX
            grads = [torch.zeros_like(p) if g is None else g
                     for p, g in zip(params.values(), grads)]
            sum_tensors(grads)
            gnorm = torch.sqrt(sum((g * g).sum() for g in grads))
            if cfg.grad_clip > 0:
                scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-6), max=1.0)
                grads = [g * scale for g in grads]
            momentum_update(state.mu, params, grads, lr, cfg.momentum,
                            self.factors)
            losses = all_reduce_sum(torch.stack([loss, loss_d, loss_c]))
        state.step += 1
        return state, {"loss": losses[0], "loss_d": losses[1],
                       "loss_c": losses[2], "lr": lr, "gnorm": gnorm}

    @torch.no_grad()
    def eval_logits(self, state: DistillState, batch) -> torch.Tensor:
        """The student's logits [B, num_labels] of ``batch`` (JAX's
        ``make_eval_fn``; module_distill_other.py:58-80): the central
        crop, the scene embedding without drop path, the head's BatchNorm
        on its running statistics."""
        mel, frames = self._features(*self._batch(batch))
        state.head.eval()
        try:
            return state.head(self.student_scene(mel, frames))
        finally:
            state.head.train()

    def eval_all(self, state: DistillState, batch) -> torch.Tensor:
        """:meth:`eval_logits` of a batch every rank holds whole, the same
        on every rank (``parallel.gather_rows``)."""
        return gather_rows(lambda rows: self.eval_logits(state, rows), batch)
