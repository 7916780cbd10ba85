"""Finetuning driver (PyTorch port of ``audiossl_tpu/downstream/
train_finetune.py``; reference ``atst_downstream_train_finetune``,
``methods/atst/downstream/train_finetune.py:48-201``): the pretrained
encoder and a linear head trained together (``downstream/finetune.py``),
validated every epoch, and the best epoch's state tested.

    python -m audiossl_tpu_torch.downstream.train_finetune \\
        --pretrained_ckpt_path last.ckpt --data_path DATA \\
        --dataset_name spcv2 --model_type clip --arch base [--device cpu]

The flags are JAX's, plus ``--device`` (default ``cuda``; without a card
that raises, it never falls back to the CPU). The learning rate is
``learning_rate * batch_size / 256``, the warm-up ``warmup_epochs`` epochs
of steps. AudioSet datasets sample the training split with replacement by
class-balanced weights; the encoder is ``train_freeze.load_encoder``'s
(the f32 module route, 1001 frames of position embeddings, as JAX's), so
a frame encoder cannot take a crop of more than 10 s, as in JAX. The top
states by the validation metric are kept on disk under ``save_path`` (10
for AudioSet, else 1), and the test split runs on the best one. Mixup's
Beta weights come from a seeded ``numpy`` generator, every other draw from
a seeded ``torch.Generator`` on the host.

``--n_devices N`` (default: every visible card, 1 on the CPU; or
torchrun's ``WORLD_SIZE``) runs N ranks (``parallel.launch.run_cli``), as
JAX's ``downstream_spmd``: every rank loads the whole global batch of
``--batch_size`` (the learning rate is not scaled by N) with the same
draws, steps on its rows of it (a batch whose rows do not divide runs
whole on every rank, ``parallel.batch_rows``) with every reduction global,
evaluates its rows of each evaluation batch and receives all of them;
rank 0 alone prints, keeps states and writes ``result.json``.
"""
from __future__ import annotations

import argparse
import functools
import json
import os
import time
from typing import Optional

import numpy as np
import torch

from audiossl_tpu_torch.datasets import get_dataset
from audiossl_tpu_torch.datasets.pipeline import BatchLoader
from audiossl_tpu_torch.downstream.finetune import (FinetuneConfig,
                                                    FinetuneTask,
                                                    draw_finetune)
from audiossl_tpu_torch.downstream.metrics import Metric
from audiossl_tpu_torch.downstream.train_freeze import load_encoder
from audiossl_tpu_torch.kernels.build import resolve_device
from audiossl_tpu_torch.parallel.launch import add_n_devices, print0, run_cli
from audiossl_tpu_torch.parallel.mesh import batch_rows, world

SEED = 0  # the head's weight and the step's draws


def build_parser():
    p = argparse.ArgumentParser("atst_downstream_train_finetune")
    p.add_argument("--pretrained_ckpt_path", required=True)
    p.add_argument("--data_path", required=True)
    p.add_argument("--dataset_name", required=True)
    p.add_argument("--save_path", default=None)
    p.add_argument("--model_type", default="clip",
                   choices=["clip", "frame"])
    p.add_argument("--arch", default="small",
                   choices=["tiny", "small", "base"])
    p.add_argument("--learning_rate", type=float, default=5e-4)
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--max_epochs", type=int, default=50)
    p.add_argument("--warmup_epochs", type=int, default=5)
    p.add_argument("--layer_wise_lr", type=float, default=0.75)
    p.add_argument("--mixup", action="store_true", default=True)
    p.add_argument("--no-mixup", dest="mixup", action="store_false")
    # per-dataset finetune knobs from the reference shell recipes
    # (shell/downtream/finetune/eval_func.sh args 9-17)
    p.add_argument("--alpha", type=float, default=0.5,
                   help="mixup beta parameter")
    p.add_argument("--mixup_ratio", type=float, default=1.0,
                   help="probability of mixing each sample")
    p.add_argument("--mask_aug", action="store_true",
                   help="SpecAugment-style freq/time masking")
    p.add_argument("--rrc", action="store_true",
                   help="RandomResizeCrop on the training mel")
    p.add_argument("--freeze_embed", action="store_true",
                   help="zero LR on patch/pos/mask embeddings")
    p.add_argument("--use_encoder", default="teacher",
                   choices=["teacher", "student"],
                   help="branch to load from distilled checkpoints")
    p.add_argument("--n_last_blocks", type=int, default=12)
    p.add_argument("--train_len", type=float, default=12.0)
    p.add_argument("--fold", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="device of the training and evaluation (raises "
                        "for cuda without a card)")
    add_n_devices(p)
    return p


def host_modules(state) -> dict:
    """A host copy of the state dicts of ``state``'s trained ``encoder``
    and ``head``."""
    return {name: {k: v.detach().to("cpu", copy=True)
                   for k, v in getattr(state, name).state_dict().items()}
            for name in ("encoder", "head")}


def load_modules(state, saved) -> None:
    """Load :func:`host_modules`' copy ``saved`` into ``state``."""
    state.encoder.load_state_dict(saved["encoder"])
    state.head.load_state_dict(saved["head"])


def build_task(args, info, enc, steps_per_epoch: int) -> FinetuneTask:
    """The task the flags ``args`` ask for on dataset ``info`` with the
    loaded encoder ``enc``: the learning rate scaled by the batch, the
    warm-up in steps, the head's input of the last blocks (CLS and mean
    for a clip encoder), its weight drawn from ``SEED``."""
    n_blocks = args.n_last_blocks
    embed_dim = enc.embed_dim * n_blocks * (
        2 if args.model_type == "clip" else 1)
    cfg = FinetuneConfig(
        learning_rate=args.learning_rate * args.batch_size / 256.0,
        max_epochs=args.max_epochs,
        steps_per_epoch=steps_per_epoch,
        warmup_steps=args.warmup_epochs * steps_per_epoch,
        layer_wise_lr=args.layer_wise_lr,
        multi_label=info.multi_label,
        num_labels=info.num_labels,
        n_blocks=n_blocks,
        crop_len_s=args.train_len,
        mixup=args.mixup,
        mixup_alpha=args.alpha,
        mixup_ratio=args.mixup_ratio,
        specaug=args.mask_aug,
        rrc=args.rrc,
        freeze_embed=args.freeze_embed,
    )
    return FinetuneTask(enc, cfg, embed_dim,
                        generator=torch.Generator().manual_seed(SEED))


def main(argv=None, record: Optional[dict] = None):
    """Finetune on ``--n_devices`` ranks (``parallel.launch.run_cli``),
    validate every epoch, test the best state; -> the result dict
    (dataset, val, test) also printed and written to
    ``save_path/result.json``, or None where the ranks were started here.
    The loss is read on the host once an epoch, as JAX reads it.
    ``record``, when given (rank 0's), receives ``steps`` (per epoch, each
    step's (clips, seconds to its loss on the host): only then does each
    step wait for the device), ``evals`` (per evaluation, its split and
    (clips, seconds) per batch, loading included), ``final`` (the trained
    modules after the last epoch, on the host) and ``test``."""
    return run_cli(functools.partial(train, record=record),
                   build_parser().parse_args(argv))


def train(args, record: Optional[dict] = None):
    """One rank's run (or the only one) of :func:`main`."""
    dev = resolve_device(args.device)
    if not world().is_main:
        record = None
    info = get_dataset(args.dataset_name)
    enc = load_encoder(args.pretrained_ckpt_path, args.model_type,
                       args.arch, which=args.use_encoder, device=dev)

    def make_loader(split, shuffle):
        kw = dict(fold=args.fold) if info.num_folds > 1 else {}
        ds = info.creator(args.data_path, split=split, **kw)
        weights = None
        if shuffle and args.dataset_name.startswith("audioset"):
            # class-balanced sampling for AudioSet finetuning
            # (reference WeightedRandomSampler, train_finetune.py:48-110)
            from audiossl_tpu_torch.methods.distill.train import (
                class_balance_weights,
            )

            weights = class_balance_weights(ds, info.num_labels)
        return BatchLoader(ds, args.batch_size,
                           pad_samples=int(args.train_len * 16000),
                           shuffle=shuffle, drop_last=shuffle,
                           weights=weights)

    train_loader = make_loader("train", True)
    task = build_task(args, info, enc, max(len(train_loader), 1))
    state = task.init_state()
    gen = torch.Generator().manual_seed(SEED + 1)
    rng = np.random.default_rng(SEED + 2)
    if record is not None:
        record.update(steps=[], evals=[])

    def eval_split(split):
        m = Metric("mAP" if info.multi_label else "ACC")
        timings = []
        t0 = time.perf_counter()
        for batch in make_loader(split, False):
            logits = task.eval_all(state, batch).cpu().numpy()
            if info.multi_label:
                logits = 1.0 / (1.0 + np.exp(-logits))
            m.update(logits, batch["label"])
            t1 = time.perf_counter()
            timings.append((len(logits), t1 - t0))
            t0 = t1
        if record is not None:
            record["evals"].append((split, timings))
        return m.compute()

    # reference persists save_top_k=10 for audioset else 1
    # (train_finetune.py:122), monitored max on the val metric
    keeper = None
    if args.save_path:
        from audiossl_tpu_torch.training.checkpoint import TopKKeeper

        keeper = TopKKeeper(args.save_path,
                            k=10 if "audioset" in args.dataset_name else 1)
    best_val, best_state, loss = -1.0, None, float("nan")
    for epoch in range(args.max_epochs):
        train_loader.set_epoch(epoch)
        times = []
        t0 = time.perf_counter()
        for batch in train_loader:
            B, L = np.shape(batch["wav"])
            draws = draw_finetune(task.cfg, B, task.rows(B, L), enc.depth,
                                  gen, rng, dev)
            with batch_rows(batch) as rows:
                state, metrics = task.train_step(state, rows, draws)
            loss = metrics["loss"]
            if record is not None:
                float(loss)  # waits for the device
                t1 = time.perf_counter()
                times.append((B, t1 - t0))
                t0 = t1
        if record is not None:
            record["steps"].append(times)
        v = eval_split("valid")
        print0(f"epoch {epoch}: val={v:.4f} loss={float(loss):.4f}",
               flush=True)
        if v > best_val or keeper is not None:
            host = host_modules(state)
        if v > best_val:
            best_val, best_state = v, host
        if keeper is not None:
            keeper.update(v, epoch, host)

    if record is not None:
        record["final"] = host_modules(state)
    if keeper is not None:
        restored = keeper.restore_best()
        if restored is not None:
            best_state = restored
    load_modules(state, best_state)
    test = eval_split("test")
    result = {"dataset": args.dataset_name, "val": best_val, "test": test}
    if record is not None:
        record["test"] = test
    print0(json.dumps(result))
    if args.save_path and world().is_main:
        os.makedirs(args.save_path, exist_ok=True)
        with open(os.path.join(args.save_path, "result.json"), "w") as f:
            json.dump(result, f)
    return result


if __name__ == "__main__":
    main()
