"""Teacher-student pretraining core: state, optimizer, EMA and the step
(PyTorch port of ``audiossl_tpu/training/pretrain.py``).

One step: draw the step's random numbers, run the student with autograd
and the teacher without, back-propagate the loss, then update every
student leaf with AdamW and the teacher's leaves with the EMA in one pass
(kernel K7, ``ops/adamw_ema.py``). The order is the JAX step's
(``pretrain.py:252-291``): lr, wd and the EMA momentum come from the step
before it is incremented, and Adam's count is incremented before its bias
corrections. The teacher runs in train mode, so its stochastic depth is
on and its BatchNorms update their own running statistics; the EMA covers
the teacher's parameters only (encoder and projector: no predictor, no BN
statistics).

Optimizer semantics are the reference's: AdamW with betas (0.9, 0.999),
eps 1e-6, bias correction and decoupled weight decay on parameters with
two or more dimensions (``wd_mask``), lr/wd/EMA momentum from cosine
schedules of the step.

Data parallel (a process group of n ranks, ``parallel/mesh.py``): each
rank's loss is its share of the global batch's, so after the backward the
gradients are summed over ranks (``reduce_grads``) and every rank takes
the same update. ZeRO-1 (:func:`shard_optimizer`) keeps on each rank the
moments of the leaves it owns; K7 updates those leaves and their teacher
copies, and each owner then sends them to every rank. The update is
elementwise, so the parameters are those of the replicated step, bit for
bit (the JAX package shards each moment's leading axis instead,
``mesh.shard_opt_state_tree``). The logged loss is the global one.

A state may hold no teacher (``teacher=None``: the MAE and dual methods,
whose JAX steps are optax's ``scale_by_adam`` then ``apply_adamw_update``).
Every leaf then has no teacher copy, and K7 runs AdamW alone: the same
step, with no EMA and no ``ema`` metric.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict, List, Optional

import torch
from torch import nn

from audiossl_tpu_torch.models.atst import AudioTransformer
from audiossl_tpu_torch.models.byol import Projector
from audiossl_tpu_torch.ops.adamw_ema import (LeafTable, adamw_ema,
                                              adamw_ema_ref, update_scalars)
from audiossl_tpu_torch.parallel.mesh import (all_reduce_sum,
                                              broadcast_groups,
                                              partition_leaves, reduce_grads,
                                              world)
from audiossl_tpu_torch.training.schedules import cosine_schedule


class Branch(nn.Module):
    """encoder + projector (+ predictor): the reference MultiCropWrapper
    over equal-width crops. ``projector`` is "mlp", "linear" or "none"
    (:class:`Projector`). The teacher's encoder keeps the serving
    state-dict names under ``encoder.``."""

    def __init__(self, encoder: AudioTransformer, predictor: bool = True,
                 hidden_dim: int = 4096, out_dim: int = 256,
                 projector: str = "mlp"):
        super().__init__()
        self.encoder = encoder
        self.head = Projector(encoder.embed_dim, predictor, hidden_dim,
                              out_dim, device=encoder.pos_embed.device,
                              projector=projector)

    def forward(self, mel, length=None, mask_index=None, apply_mask=True,
                dps: Optional[torch.Tensor] = None):
        """Frame encoder: -> (head output [B, T, out_dim] f32, selection
        mask [B, T]). Clip encoder: -> head output of the CLS embeddings
        [B, out_dim] f32. Without an MLP head (the data2vec branches) the
        output is in the encoder's dtype, as in JAX."""
        out = self.encoder(mel, length, mask_index, apply_mask, dps)
        if self.encoder.use_cls:
            return self.head(out, None, self.encoder.dtype)
        frames, sel = out
        return self.head(frames, sel, self.encoder.dtype), sel


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    learning_rate: float = 5e-4
    warmup_steps: int = 1300
    max_steps: int = 39010
    ema: float = 0.99
    wd_start: float = 0.04
    wd_end: float = 0.4
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-6

    def lr_schedule(self):
        return cosine_schedule(self.learning_rate, 1e-6, self.max_steps,
                               self.warmup_steps)

    def wd_schedule(self):
        return cosine_schedule(self.wd_start, self.wd_end, self.max_steps, 0)

    def ema_schedule(self):
        return cosine_schedule(self.ema, 1.0, self.max_steps, 0)


@dataclasses.dataclass
class PretrainState:
    """The step count, both branches (f32 master parameters; ``teacher``
    None for a method without one), Adam's moments and count per student
    parameter name, and the generator of every random draw. ``owners``
    (ZeRO-1, :func:`shard_optimizer`) gives each student parameter's
    owning rank, and the moments are then the owned ones only; None:
    every moment on every rank. The update's leaves are paired when the
    state is made: every student parameter (``params``), the ones the
    moments update in their order (``leaves``), the teacher's copy of each
    or None (``teacher_leaves``), whether each decays (``decay``), and
    under ZeRO-1 each rank's updated leaves and teacher copies
    (``groups``)."""
    step: int
    student: nn.Module
    teacher: Optional[nn.Module]
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]
    count: int
    generator: torch.Generator
    owners: Optional[Dict[str, int]] = None
    params: List[nn.Parameter] = dataclasses.field(init=False, repr=False)
    leaves: List[nn.Parameter] = dataclasses.field(init=False, repr=False)
    teacher_leaves: List[Optional[nn.Parameter]] = dataclasses.field(
        init=False, repr=False)
    decay: List[bool] = dataclasses.field(init=False, repr=False)
    groups: Optional[List[List[torch.Tensor]]] = dataclasses.field(
        init=False, repr=False)

    def __post_init__(self):
        self.pair()

    def pair(self) -> None:
        """Pairs the leaves anew (after the moments or owners changed)."""
        params = dict(self.student.named_parameters())
        t_params = ({} if self.teacher is None
                    else dict(self.teacher.named_parameters()))
        mask = wd_mask(self.student)
        self.params = list(params.values())
        self.leaves = [params[k] for k in self.mu]
        self.teacher_leaves = [t_params.get(k) for k in self.mu]
        self.decay = [mask[k] for k in self.mu]
        self.groups = None
        if self.owners is not None:
            self.groups = [[] for _ in range(world().size)]
            for k, r in self.owners.items():
                self.groups[r] += [params[k]] + (
                    [t_params[k]] if k in t_params else [])


def shard_optimizer(state: PretrainState) -> None:
    """ZeRO-1 over the process group: each rank keeps the moments of the
    student parameters it owns (``parallel.partition_leaves``: whole
    leaves, greedy by bytes) and drops the rest. Nothing changes in one
    process."""
    w = world()
    if w.size == 1 or state.owners is not None:
        return
    params = dict(state.student.named_parameters())
    owner = partition_leaves([p.numel() * p.element_size()
                              for p in params.values()], w.size)
    state.owners = dict(zip(params, owner))
    state.mu = {k: v for k, v in state.mu.items()
                if state.owners[k] == w.rank}
    state.nu = {k: state.nu[k] for k in state.mu}
    state.pair()


@torch.no_grad()
def full_moments(state: PretrainState):
    """(mu, nu) of every student parameter, in the parameters' order: the
    state's own, or under ZeRO-1 each owner's sent to every rank (a
    collective: every rank calls it)."""
    if state.owners is None:
        return state.mu, state.nu
    rank = world().rank
    mu, nu = {}, {}
    groups = [[] for _ in range(world().size)]
    for k, p in state.student.named_parameters():
        r = state.owners[k]
        mu[k] = state.mu[k] if r == rank else torch.empty_like(p)
        nu[k] = state.nu[k] if r == rank else torch.empty_like(p)
        groups[r] += [mu[k], nu[k]]
    broadcast_groups(groups)
    return mu, nu


def wd_mask(module: nn.Module) -> Dict[str, bool]:
    """True where decoupled weight decay applies: parameters with >= 2
    dimensions (the reference's param groups: not biases, not norms;
    ``pos_embed`` and ``mask_embed`` decay)."""
    return {k: p.ndim >= 2 for k, p in module.named_parameters()}


@torch.no_grad()
def copy_into_structure(teacher: nn.Module, student: nn.Module) -> None:
    """Fill every parameter and buffer of ``teacher`` with the same-named
    one of ``student`` (the teacher holds no predictor)."""
    src = student.state_dict()
    teacher.load_state_dict({k: src[k] for k in teacher.state_dict()})


def init_pretrain_state(student: nn.Module, teacher: Optional[nn.Module],
                        generator: torch.Generator) -> PretrainState:
    """Teacher = student restricted to the teacher's modules (none where
    ``teacher`` is None); zero moments."""
    if teacher is not None:
        copy_into_structure(teacher, student)
    params = dict(student.named_parameters())
    return PretrainState(
        step=0, student=student, teacher=teacher,
        mu={k: torch.zeros_like(p) for k, p in params.items()},
        nu={k: torch.zeros_like(p) for k, p in params.items()},
        count=0, generator=generator)


def make_pretrain_step(cfg: OptimizerConfig, forward_loss: Callable,
                       plain: bool = False):
    """Build the step ``(state, batch, draws=None) -> metrics``.

    ``forward_loss(student, teacher, batch, generator, draws)`` returns
    ``(loss, aux)`` (``teacher`` None for a state without one); ``draws``
    (None: drawn from the state's generator) lets a caller pass the random
    numbers in. The state is updated in
    place. ``plain=True`` takes K7's plain version on any device. Outside
    the model, the step's host work per leaf is collecting the gradients
    and moments; nothing in the update waits for the device. Under a
    process group ``draws`` are the global batch's and ``batch`` this
    rank's rows of it."""
    lr_s, wd_s, ema_s = (cfg.lr_schedule(), cfg.wd_schedule(),
                         cfg.ema_schedule())
    # K7's device table, kept between steps (rebuilt only for other leaves)
    update = (adamw_ema_ref if plain
              else functools.partial(adamw_ema, table=LeafTable()))

    def step_fn(state: PretrainState, batch, draws=None):
        lr, wd, m = lr_s(state.step), wd_s(state.step), ema_s(state.step)
        student = state.student.train()
        teacher = None if state.teacher is None else state.teacher.train()
        for p in state.params:
            p.grad = None
        loss, aux = forward_loss(student, teacher, batch, state.generator,
                                 draws)
        loss.backward()
        reduce_grads(state.params)
        state.count += 1
        if state.leaves:
            update(state.leaves,
                   [p.grad if p.grad is not None else torch.zeros_like(p)
                    for p in state.leaves],
                   list(state.mu.values()),
                   [state.nu[k] for k in state.mu], state.teacher_leaves,
                   state.decay,
                   update_scalars(lr, wd, m, state.count, cfg.b1, cfg.b2,
                                  cfg.eps))
        if state.groups is not None:
            broadcast_groups(state.groups)
        state.step += 1
        ema = {} if teacher is None else {"ema": m}
        return {"loss": all_reduce_sum(loss.detach()), "lr": lr, "wd": wd,
                **ema, **aux}

    return step_fn
