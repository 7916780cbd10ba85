"""ATST-C2F distillation on AudioSet (PyTorch port of ``audiossl_tpu/
methods/distill/train.py``; reference ``methods/atstframe/
train_distill.py:28-86``): a frozen finetuned clip classifier distilled
into an ATST-Frame student (``method.py``), with class-balanced sampling.

    python -m audiossl_tpu_torch.methods.distill.train \\
        --data_path DATA --teacher_ckpt_path clip_classifier.ckpt \\
        --student_ckpt_path frame_pretrain.ckpt --save_path OUT \\
        [--balanced_sampling] [--device cpu]

The flags are JAX's, plus ``--device`` (default ``cuda``; without a card
that raises, it never falls back to the CPU) and ``--n_devices``. The
learning rate is ``learning_rate * batch_size / 256``, an epoch
``len(train) // batch_size`` steps of 10 s crops. The state is saved under
``save_path/ckpt`` at each epoch's end by ``training.checkpoint.
CheckpointManager`` (the first save always, later ones on its interval, as
JAX's manager takes them); its ``student`` entry is what
``load_pretrain_checkpoint(which="student")`` and the ``distillatst``
adapter read. The step's draws come from a seeded ``torch.Generator`` on
the host.

``--n_devices N`` (default: every visible card, 1 on the CPU; or
torchrun's ``WORLD_SIZE``) runs N ranks (``parallel.launch.run_cli``), as
JAX's ``downstream_spmd``: every rank loads the whole global batch (the
learning rate is not scaled by N) with the same draws and steps on its rows
of it with every reduction global (``method.DistillMethod.train_step``);
rank 0 alone prints and saves.
"""
from __future__ import annotations

import argparse
import functools
import os
import time
from typing import Optional

import numpy as np
import torch

from audiossl_tpu_torch.compat.checkpoint import (linear_head_state_from_torch,
                                                  load_encoder_state,
                                                  strip_prefixes, subtree)
from audiossl_tpu_torch.datasets.packed import PackedAudioDataset
from audiossl_tpu_torch.datasets.pipeline import BatchLoader
from audiossl_tpu_torch.kernels.build import resolve_device
from audiossl_tpu_torch.methods.distill.method import (DistillConfig,
                                                       DistillMethod,
                                                       host_state,
                                                       student_state)
from audiossl_tpu_torch.models.heads import LinearHead
from audiossl_tpu_torch.parallel.launch import add_n_devices, print0, run_cli
from audiossl_tpu_torch.parallel.mesh import batch_rows, world
from audiossl_tpu_torch.training.checkpoint import CheckpointManager

SEED = 0  # the student head's weight; SEED + 1 the steps' draws
LOG_EVERY = 50


def class_balance_weights(dataset, num_labels: int) -> np.ndarray:
    """Per-record sampling weights: 1 / sqrt(class frequency) summed over a
    record's active labels (reference ``test_sampler.py``'s
    ``weights_labels``), at least 1e-8. Reads every record's label through
    ``dataset[i]``, as JAX's does."""
    counts = np.zeros(num_labels)
    labels = []
    for i in range(len(dataset)):
        _, y = dataset[i][:2]
        y = np.asarray(y)
        labels.append(y)
        counts += y
    counts = np.maximum(counts, 1.0)
    w = np.array([(y / np.sqrt(counts)).sum() for y in labels])
    return np.maximum(w, 1e-8)


def build_parser():
    p = argparse.ArgumentParser("train_distill")
    p.add_argument("--data_path", required=True)
    p.add_argument("--teacher_ckpt_path", required=True,
                   help="finetuned clip classifier (encoder+LinearHead)")
    p.add_argument("--student_ckpt_path", required=True,
                   help="pretrained FrameAST checkpoint")
    p.add_argument("--save_path", default=None)
    p.add_argument("--num_labels", type=int, default=527)
    p.add_argument("--lambda_d", type=float, default=1.0)
    p.add_argument("--learning_rate", type=float, default=1e-1)
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--max_epochs", type=int, default=40)
    p.add_argument("--warmup_epochs", type=int, default=2)
    p.add_argument("--layer_wise_lr", type=float, default=0.75)
    p.add_argument("--balanced_sampling", action="store_true")
    add_device_flags(p)
    return p


def add_device_flags(p) -> None:
    """``--device`` and ``--n_devices``, the port's flags of both
    distillation CLIs."""
    p.add_argument("--device", default="cuda",
                   help="device of the training (raises for cuda without "
                        "a card)")
    add_n_devices(p)


def load_teacher_student(teacher_ckpt_path: str, student_ckpt_path: str,
                         cfg: DistillConfig, device="cuda"):
    """-> (the teacher's clip encoder, its LinearHead, the student's frame
    encoder), f32 on ``device``, of ``cfg.arch`` at ``cfg.pretrain_frames``
    frames (JAX's ``load_teacher_student``; reference
    ``train_distill.py:40-56``).

    The teacher is a finetuned classifier's ``.ckpt``: its state dict
    with the ``module.``/``backbone.`` prefixes stripped, the encoder under
    ``encoder.encoder.`` (or ``encoder.``) in either patch-embed layout,
    the head under ``head.`` (``compat.checkpoint.
    linear_head_state_from_torch``). The student is a reference
    pretraining ``.ckpt`` or the port's own pretraining checkpoint (a
    ``state.pt`` or its step directory), its teacher branch
    (``train_freeze.load_encoder``); its position table must cover
    ``cfg.pretrain_frames`` frames, the width JAX builds it at. Any other
    student path (an orbax directory) raises ``NotImplementedError``."""
    from audiossl_tpu_torch.downstream.train_freeze import _MAKERS, load_encoder

    device = resolve_device(device)
    ckpt = torch.load(teacher_ckpt_path, map_location="cpu",
                      weights_only=True)
    sd = strip_prefixes(ckpt.get("state_dict", ckpt))
    enc_sd = subtree(sd, "encoder.encoder.") or subtree(sd, "encoder.")
    # built on the meta device: the checkpoint's tensors are its weights
    teacher = _MAKERS[("clip", cfg.arch)](spec_w=cfg.pretrain_frames,
                                          device="meta")
    load_encoder_state(teacher, enc_sd, assign=True)
    head_sd = linear_head_state_from_torch(subtree(sd, "head."))
    w = head_sd["linear.weight"]
    t_head = LinearHead(w.shape[1], w.shape[0], device="cpu")
    t_head.load_state_dict(head_sd)
    student = load_encoder(student_ckpt_path, "frame", cfg.arch,
                           spec_w=cfg.pretrain_frames, which="teacher",
                           device=device)
    if student.spec_w != cfg.pretrain_frames:
        raise ValueError(
            f"{student_ckpt_path}: the student's position embeddings cover "
            f"{student.spec_w} frames; distillation builds it at "
            f"{cfg.pretrain_frames}")
    return (teacher.to(device, torch.float32), t_head.to(device), student)


def build_config(args, steps_per_epoch: int) -> DistillConfig:
    """The configuration JAX's driver makes of the flags ``args``: the
    learning rate scaled by the batch."""
    return DistillConfig(
        num_labels=args.num_labels, lambda_d=args.lambda_d,
        learning_rate=args.learning_rate * args.batch_size / 256.0,
        max_epochs=args.max_epochs, steps_per_epoch=steps_per_epoch,
        warmup_epochs=args.warmup_epochs, layer_wise_lr=args.layer_wise_lr)


def build_method(cfg: DistillConfig, args, device):
    """The method of ``cfg`` on the checkpoints the flags ``args`` name,
    and its state at step 0."""
    teacher, t_head, student = load_teacher_student(
        args.teacher_ckpt_path, args.student_ckpt_path, cfg, device)
    method = DistillMethod(cfg, teacher, t_head, student,
                           generator=torch.Generator().manual_seed(SEED))
    return method, method.init_state(torch.Generator().manual_seed(SEED + 1))


def fit_epoch(method, state, loader, record: Optional[dict] = None):
    """One epoch of steps over ``loader``, each on this rank's rows of its
    batch; prints every ``LOG_EVERY`` steps. ``record``, when given,
    receives the epoch's steps' (clips, seconds to the loss on the host,
    loss, loss_d, loss_c) under ``steps``: only then does each step wait
    for the device. -> (state, the last step's metrics)."""
    times = []
    metrics = {}
    t0 = time.perf_counter()
    for batch in loader:
        B, L = np.shape(batch["wav"])
        draws = method.draw(state, B, L)
        with batch_rows(batch) as rows:
            state, metrics = method.train_step(state, rows, draws)
        if state.step % LOG_EVERY == 0:
            print0(f"step {state.step} " + " ".join(
                f"{k}={float(v):.5g}" for k, v in sorted(metrics.items())),
                flush=True)
        if record is not None:
            losses = [float(metrics[k]) for k in ("loss", "loss_d", "loss_c")]
            t1 = time.perf_counter()
            times.append((B, t1 - t0, *losses))
            t0 = t1
    if record is not None:
        record.setdefault("steps", []).append(times)
    return state, metrics


def save_epoch(mgr, state, record: Optional[dict]) -> None:
    """The epoch's save (the manager's rules decide); ``record`` receives
    the saved student's host copy by step under ``saved``."""
    if mgr is not None and mgr.save(state.step, state) and record is not None:
        record.setdefault("saved", {})[state.step] = student_state(state)


def main(argv=None, record: Optional[dict] = None):
    """Distill on ``--n_devices`` ranks; -> the final state, or None where
    the ranks were started here. ``record`` (rank 0's), when given,
    receives ``steps`` (:func:`fit_epoch`) and ``saved``
    (:func:`save_epoch`)."""
    return run_cli(functools.partial(train, record=record),
                   build_parser().parse_args(argv))


def train(args, record: Optional[dict] = None):
    """One rank's run (or the only one) of :func:`main`."""
    dev = resolve_device(args.device)
    if not world().is_main:
        record = None
    dataset = PackedAudioDataset(args.data_path, "train")
    weights = None
    if args.balanced_sampling:
        weights = class_balance_weights(dataset, args.num_labels)
    cfg = build_config(args, max(len(dataset) // args.batch_size, 1))
    method, state = build_method(cfg, args, dev)
    mgr = (CheckpointManager(os.path.join(args.save_path, "ckpt"),
                             to_host=host_state)
           if args.save_path else None)
    loader = BatchLoader(dataset, args.batch_size,
                         pad_samples=cfg.out_samples, shuffle=True,
                         weights=weights)
    for epoch in range(args.max_epochs):
        loader.set_epoch(epoch)
        state, _ = fit_epoch(method, state, loader, record)
        save_epoch(mgr, state, record)
    if mgr is not None:
        mgr.close()
    return state


if __name__ == "__main__":
    main()
