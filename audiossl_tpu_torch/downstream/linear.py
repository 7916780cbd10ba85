"""Linear probing on cached embeddings (PyTorch port of
``audiossl_tpu/downstream/linear.py``, phase 2 of ``train_freeze``).

Reference ``LinearClassifierPLModule`` (``methods/atst/downstream/
model.py:44-127``): a :class:`~audiossl_tpu_torch.models.heads.LinearHead`
(BatchNorm without affine, then a Linear) trained by SGD with momentum 0.9
and no weight decay, cross-entropy or (multi-label) sigmoid cross-entropy
summed over the labels, the best epoch chosen on the validation metric
(ACC or mAP) and the test metric reported at that epoch's head.

The optimisation is JAX's step for step: ``bs = min(batch_size, n)``,
``n // bs`` steps an epoch over a fresh permutation (its remainder
dropped), the learning rate ``learning_rate * lr_scale`` decayed by a
cosine per optimiser step over ``max_epochs * steps_per_epoch`` steps from
the full rate at step 0 (optax's ``cosine_decay_schedule``), momentum as
``optax.trace`` (``buf = g + 0.9 buf``, then ``p -= lr * buf``). The
embeddings stay on the device for the whole run.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Mapping, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from audiossl_tpu_torch.downstream.metrics import Metric
from audiossl_tpu_torch.kernels.build import resolve_device
from audiossl_tpu_torch.models.heads import LinearHead


@dataclasses.dataclass
class LinearProbeConfig:
    learning_rate: float = 2e-3      # reference eval_env.sh default
    batch_size: int = 1024
    max_epochs: int = 100            # reference train_freeze.py default
    momentum: float = 0.9
    multi_label: bool = False
    num_labels: int = 0
    lr_scale: float = 1.0            # lr * world_bs / 256, set by the caller
    seed: int = 0


@dataclasses.dataclass
class ProbeDraws:
    """The probe's random numbers, handed in (a test passes JAX's):
    ``perms`` one permutation of the n training rows per epoch, ``head``
    the initial ``LinearHead`` state dict (None: drawn from the seed)."""
    perms: Sequence
    head: Optional[Mapping[str, torch.Tensor]] = None


def _loss(logits, labels, multi_label: bool):
    if multi_label:  # optax's sigmoid BCE, summed over labels
        return F.binary_cross_entropy_with_logits(
            logits, labels, reduction="none").sum(-1).mean()
    return F.cross_entropy(logits, labels)


def cosine_decay(lr: float, decay_steps: int, step: int) -> float:
    """optax ``cosine_decay_schedule(lr, decay_steps)`` at ``step``."""
    t = min(step, decay_steps) / decay_steps
    return lr * 0.5 * (1.0 + math.cos(math.pi * t))


def train_linear_probe(train_emb: np.ndarray, train_y: np.ndarray,
                       val_emb: np.ndarray, val_y: np.ndarray,
                       test_emb: np.ndarray, test_y: np.ndarray,
                       cfg: LinearProbeConfig, keeper=None, device="cuda",
                       draws: Optional[ProbeDraws] = None) -> dict:
    """Train the head, select the best epoch by the validation metric
    (strictly greater, from -1; an empty validation split uses -loss) and
    report the test metric with that epoch's head, on ``device`` (the card
    unless the caller asks for the CPU).

    ``keeper``: an optional ``training.checkpoint.TopKKeeper`` that keeps
    the top-k epochs' heads (reference ModelCheckpoint save_top_k=10 on
    the validation metric). ``draws``: the permutations and initial head
    (:class:`ProbeDraws`); without them both come from a
    ``torch.Generator`` seeded with ``cfg.seed``. Returns ``val_metric``,
    ``test_metric``, ``train_losses`` (the mean loss of each epoch) and
    ``state`` (the best epoch's head state dict)."""
    dev = resolve_device(device)
    num_labels = cfg.num_labels or (
        train_y.shape[1] if train_y.ndim == 2 else int(train_y.max()) + 1)
    gen = torch.Generator().manual_seed(cfg.seed)
    head = LinearHead(train_emb.shape[1], num_labels, generator=gen)
    if draws is not None and draws.head is not None:
        head.load_state_dict(draws.head)
    head.to(dev)
    params = list(head.parameters())
    bufs = [torch.zeros_like(p) for p in params]

    lr = cfg.learning_rate * cfg.lr_scale
    n = len(train_emb)
    bs = min(cfg.batch_size, n)
    steps_per_epoch = max(n // bs, 1)
    total_steps = cfg.max_epochs * steps_per_epoch
    multi = cfg.multi_label

    def labels(y):
        return torch.as_tensor(np.asarray(y), device=dev,
                               dtype=torch.float32 if multi else torch.int64)

    x_all = torch.as_tensor(np.asarray(train_emb, np.float32), device=dev)
    y_all = labels(train_y)

    def evaluate(emb, y):
        m = Metric("mAP" if multi else "ACC")
        head.eval()
        with torch.no_grad():
            logits = head(torch.as_tensor(np.asarray(emb, np.float32),
                                          device=dev)).cpu().numpy()
        head.train()
        m.update(1.0 / (1.0 + np.exp(-logits)) if multi else logits, y)
        return m.compute()

    best_val, best = -1.0, None
    losses = []
    step = 0
    for epoch in range(cfg.max_epochs):
        if draws is not None:
            perm = torch.tensor(np.asarray(draws.perms[epoch]),
                                dtype=torch.int64)
        else:
            perm = torch.randperm(n, generator=gen)
        idxs = perm[: steps_per_epoch * bs].reshape(steps_per_epoch, bs)
        idxs = idxs.to(dev)
        epoch_losses = []
        for idx in idxs:
            loss = _loss(head(x_all[idx]), y_all[idx], multi)
            grads = torch.autograd.grad(loss, params)
            rate = cosine_decay(lr, total_steps, step)
            with torch.no_grad():
                for p, g, buf in zip(params, grads, bufs):
                    buf.mul_(cfg.momentum).add_(g)
                    p.sub_(rate * buf)
            epoch_losses.append(loss.detach())
            step += 1
        l = float(torch.stack(epoch_losses).mean())
        losses.append(l)
        v = evaluate(val_emb, val_y) if len(val_emb) else -l
        if v > best_val:
            best_val = v
            best = {k: t.detach().clone() for k, t in
                    head.state_dict().items()}
        if keeper is not None:
            keeper.update(v, epoch, {k: t.detach().cpu() for k, t in
                                     head.state_dict().items()})

    head.load_state_dict(best)
    test_metric = evaluate(test_emb, test_y) if len(test_emb) \
        else float("nan")
    return {
        "val_metric": best_val,
        "test_metric": test_metric,
        "train_losses": losses,
        "state": best,
    }
