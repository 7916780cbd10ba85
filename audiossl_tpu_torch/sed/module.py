"""The DCASE / AudioSet-strong SED finetuning task (PyTorch port of
``audiossl_tpu/sed/module.py``; reference
``downstream/utils_dcase/model_dcase.py:71-352`` and
``utils_as_strong/model_as_strong.py:61-325``).

Frame embeddings of the pretrained encoder feed a :class:`SEDHead`. A
batch mixes strong (synthetic) and weak clips; the loss is the strong BCE
on the strong rows plus the weak BCE of the attention-pooled scores on
the weak rows, each masked and normalised by its row count. The update is
JAX's optax chain written out: SGD with ``optax.trace`` momentum (trace =
g + ``cfg.momentum`` * trace), the traced update times each parameter's
layer-decay factor when ``lr_scale`` < 1, then ``p -= lr * u``, with a
cosine learning rate per step and no weight decay.

The repository's own encoder is the f32 module route
(``train_freeze.load_encoder``), so the mel kernel K1 is the one kernel on
its path, and its drop-path uniforms are handed in (``SEDTask.draw``:
[depth, 2, B] from a ``torch.Generator``), so a test passes JAX's. A
comparison encoder (``downstream.comparison_models``) takes no drop path,
as in JAX, and runs its own front end; MAE-AST's attention is the MHA
kernel K6, forward and backward. Freeze mode runs the encoder in eval mode
with no gradient and trains the head alone.

Under a process group each rank steps on its rows of the global batch
(JAX's ``downstream_spmd``): a ``MixedBatchLoader`` batch stacks its
strong rows before its weak ones, so ranks can hold different sources,
and every count, mean and gradient is the global batch's.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import numpy as np
import torch

from audiossl_tpu_torch.downstream.comparison_models import EncoderAdapter
from audiossl_tpu_torch.downstream.finetune import _f32, layer_decay_factors
from audiossl_tpu_torch.models.atst import AudioTransformer
from audiossl_tpu_torch.models.transformer import drop_path_multipliers
from audiossl_tpu_torch.ops.melspec import MelConfig
from audiossl_tpu_torch.parallel.mesh import (all_reduce_sum, data_world,
                                              gather_rows, local_rows,
                                              replicated, sum_tensors)
from audiossl_tpu_torch.sed.head import SEDHead
from audiossl_tpu_torch.training.schedules import cosine_schedule

EPS = 1e-7  # inside the BCE logs


@dataclasses.dataclass(frozen=True)
class SEDConfig:
    """JAX's ``SEDConfig`` (``audiossl_tpu/sed/module.py:29``), plus the
    encoder's ``drop_path_rate``. ``momentum`` is the trace's decay,
    ``mel`` the own encoders' front end (its hop sets their frame
    counts), ``audio_len`` the clips' seconds (the test's durations where
    the set gives none) and ``n_test_thresholds`` the test's PSDS
    operating points."""
    num_labels: int = 10
    learning_rate: float = 1e-1
    max_epochs: int = 100
    steps_per_epoch: int = 100
    warmup_epochs: int = 10
    momentum: float = 0.9
    freeze_mode: bool = False      # a linear probe over the frozen encoder
    lr_scale: float = 1.0          # per-layer decay (as_strong: 0.75)
    audio_len: float = 10.0
    median_window: int = 7
    n_test_thresholds: int = 50
    distill_weight: float = 0.0  # > 0: add the frozen teacher's BCE
    # "add": DCASE, total += w * (strong_d + weak_d) / 2 (reference
    # utils_dcase/model_distill.py:170-174); "average_strong":
    # AudioSet-strong, total = strong / 2 + w * strong_d / 2, the weak loss
    # left out (reference utils_as_strong/model_distill_as_strong.py:
    # 123-137)
    distill_combine: str = "add"
    mel: MelConfig = MelConfig()
    sr: int = 16000
    # JAX reads the drop-path rate off its encoder (0.1 as
    # train_freeze.load_encoder builds it); the port's encoder holds none
    drop_path_rate: float = 0.1

    @property
    def max_steps(self):
        return self.max_epochs * self.steps_per_epoch

    @property
    def n_samples(self):
        return int(self.audio_len * self.sr)


@dataclasses.dataclass
class SEDState:
    """The encoder and head (trained in place), the momentum trace by
    parameter name (``mu``; the head's alone in freeze mode) and the
    step."""
    step: int
    encoder: torch.nn.Module
    head: SEDHead
    mu: Dict[str, torch.Tensor]

    @property
    def params(self) -> Dict[str, torch.nn.Parameter]:
        """The parameters the step trains, ``encoder.<name>`` (unless in
        freeze mode) then ``head.<name>``, by ``mu``'s names."""
        named = {f"encoder.{k}": p for k, p in self.encoder.named_parameters()}
        named.update((f"head.{k}", p) for k, p in self.head.named_parameters())
        return {k: named[k] for k in self.mu}


def _bce(p, y):
    return -(y * torch.log(p + EPS) + (1 - y) * torch.log(1 - p + EPS))


class SEDTask:
    def __init__(self, encoder, cfg: SEDConfig,
                 teacher_fn: Optional[Callable] = None,
                 generator: Optional[torch.Generator] = None):
        """``encoder`` is an :class:`AudioTransformer` or an adapter of
        ``downstream.comparison_models`` (``frame_embeddings``,
        ``embed_dim``, ``token_count`` and its ``encoder``, any module).
        ``teacher_fn(wav, valid) -> (strong [B, C, T], weak [B, C])``, the
        probabilities of a frozen finetuned SED teacher, enables distill
        mode. The head's weights are drawn from ``generator`` (seed 0 when
        None) on the encoder's device."""
        if isinstance(encoder, AudioTransformer):
            self.adapter = EncoderAdapter(encoder=encoder, mel=cfg.mel)
        else:
            self.adapter = encoder
        self.encoder = self.adapter.encoder
        self.cfg = cfg
        self.device = next(self.encoder.parameters()).device
        # the ATST encoders take drop path; the comparison encoders none,
        # as JAX's adapters ignore their rngs
        self.dp_depth = (self.encoder.depth
                         if isinstance(self.adapter, EncoderAdapter) else 0)
        self.head = SEDHead(self.adapter.embed_dim, cfg.num_labels,
                            device=self.device, generator=generator)
        self.teacher_fn = teacher_fn
        self.lr_sched = cosine_schedule(
            cfg.learning_rate, 1e-6, cfg.max_steps,
            cfg.warmup_epochs * cfg.steps_per_epoch)
        # per-layer factors of the traced update (reference
        # request_param_groups, utils_as_strong/model_as_strong.py:
        # 289-325); as in JAX, for an encoder handed in itself, not through
        # an adapter
        self.factors = None
        if cfg.lr_scale < 1.0 and hasattr(encoder, "depth"):
            enc = layer_decay_factors(
                [k for k, _ in self.encoder.named_parameters()],
                self.encoder.depth, cfg.lr_scale)
            self.factors = {f"encoder.{k}": v for k, v in enc.items()}

    def init_state(self) -> SEDState:
        """Step 0 with a zero momentum trace. ``load_encoder`` returns the
        encoder frozen in eval mode: outside freeze mode it is put back in
        training mode with gradients on."""
        train = not self.cfg.freeze_mode
        self.encoder.requires_grad_(train).train(train)
        self.head.requires_grad_(True).train()
        named = ({f"encoder.{k}": p for k, p in
                  self.encoder.named_parameters()} if train else {})
        named.update((f"head.{k}", p) for k, p in self.head.named_parameters())
        mu = {k: torch.zeros_like(p) for k, p in named.items()}
        return SEDState(step=0, encoder=self.encoder, head=self.head, mu=mu)

    def draw(self, gen: torch.Generator, batch: int) -> Optional[torch.Tensor]:
        """One step's drop-path uniforms [depth, 2, batch] from ``gen`` (a
        CPU generator) on the task's device; None in freeze mode, without
        drop path or for a comparison encoder."""
        if (self.cfg.freeze_mode or self.cfg.drop_path_rate == 0
                or not self.dp_depth):
            return None
        u = torch.rand(self.dp_depth, 2, batch, generator=gen)
        return u.to(self.device)

    def _batch(self, batch):
        dev = self.device
        wav = torch.as_tensor(np.asarray(batch["wav"]), device=dev).float()
        valid = torch.as_tensor(np.asarray(batch["valid"]), device=dev).long()
        return wav, valid

    def train_step(self, state: SEDState, batch,
                   dp: Optional[torch.Tensor] = None):
        """One step on ``batch`` (``wav`` [B, L], ``valid`` [B], ``strong``
        [B, T, C], ``source`` [B]: 0 strong, 1 weak) with the drop-path
        uniforms ``dp`` (:meth:`draw`); updates the state in place and
        returns it with ``loss``, ``strong_loss``, ``weak_loss`` and
        ``lr``.

        Under a process group ``batch`` is this rank's rows of the global
        batch (``parallel.shard_batch``) and ``dp`` the global batch's
        draws, of which the step takes the rank's rows. The masked counts,
        the means and the logged losses are the global batch's, and the
        gradients are summed over ranks, as one process computes them."""
        cfg = self.cfg
        lr = _f32(self.lr_sched(state.step))  # JAX's schedule runs in f32
        wav, valid = self._batch(batch)
        dev = self.device
        n = data_world().size
        y = torch.as_tensor(np.asarray(batch["strong"]), device=dev).float()
        source = torch.as_tensor(np.asarray(batch["source"]), device=dev)
        if cfg.freeze_mode:
            with torch.no_grad():
                frames = self.adapter.frame_embeddings(wav, valid)
        else:
            if dp is not None:
                dp = dp[..., local_rows(len(wav) * n)]
            dps = (None if dp is None else
                   drop_path_multipliers(dp, cfg.drop_path_rate))
            frames = self.adapter.frame_embeddings(wav, valid, dps=dps)
        strong, weak = self.head(frames)
        y = y.transpose(1, 2)  # labels arrive [B, T, C]
        T = min(strong.shape[-1], y.shape[-1])
        strong, y = strong[..., :T], y[..., :T]
        s_mask = (source == 0).to(strong.dtype)
        w_mask = (source == 1).to(strong.dtype)
        # the global batch's row counts of each source
        counts = all_reduce_sum(torch.stack([s_mask.sum(), w_mask.sum()]))
        strong_loss = (_bce(strong, y).mean(dim=(1, 2)) * s_mask).sum() / \
            counts[0].clamp_min(1.0)
        y_weak = (y.sum(-1) > 0).to(strong.dtype)
        weak_loss = (_bce(weak, y_weak).mean(-1) * w_mask).sum() / \
            counts[1].clamp_min(1.0)
        total = strong_loss + weak_loss
        if self.teacher_fn is not None and cfg.distill_weight > 0:
            with torch.no_grad():
                t_strong, t_weak = self.teacher_fn(wav, valid)
            Td = min(T, t_strong.shape[-1])
            # means over the global batch
            d = _bce(strong[..., :Td], t_strong[..., :Td])
            bce_ds = d.sum() / (d.numel() * n)
            if cfg.distill_combine == "average_strong":
                total = 0.5 * strong_loss + cfg.distill_weight * 0.5 * bce_ds
            else:
                dw = _bce(weak, t_weak)
                total = total + cfg.distill_weight * 0.5 * (
                    bce_ds + dw.sum() / (dw.numel() * n))
        params = state.params
        grads = torch.autograd.grad(total, list(params.values()),
                                    allow_unused=True)
        with torch.no_grad():
            # a parameter the loss does not reach (mask_embed) has a zero
            # gradient, as in JAX
            grads = [torch.zeros_like(p) if g is None else g
                     for p, g in zip(params.values(), grads)]
            sum_tensors(grads)
            for (name, p), g in zip(params.items(), grads):
                u = state.mu[name].mul_(cfg.momentum).add_(g).clone()
                if self.factors is not None and name in self.factors:
                    u.mul_(self.factors[name])
                p.sub_(u * lr)
            logged = all_reduce_sum(torch.stack(
                [total.detach(), strong_loss.detach(), weak_loss.detach()]))
        state.step += 1
        return state, {"loss": logged[0], "strong_loss": logged[1],
                       "weak_loss": logged[2], "lr": lr}

    def predict_all(self, state: SEDState, batch):
        """:meth:`predict` of a batch every rank holds whole, the same on
        every rank: each rank scores its rows and they are gathered
        (``parallel.gather_rows``); with ``use_norm``, whose statistics
        span the batch, every rank scores it whole."""
        if self.head.use_norm:
            with replicated():
                return self.predict(state, batch)
        return gather_rows(lambda rows: self.predict(state, rows), batch)

    @torch.no_grad()
    def predict(self, state: SEDState, batch):
        """(strong [B, C, T], weak [B, C]) of ``batch`` on the task's
        device: eval mode, no drop path, no gradient."""
        training = state.encoder.training
        state.encoder.eval()
        try:
            return state.head(self.adapter.frame_embeddings(
                *self._batch(batch)))
        finally:
            state.encoder.train(training)
