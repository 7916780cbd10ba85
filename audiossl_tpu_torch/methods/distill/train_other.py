"""Clip-to-frame distillation on the registered downstream sets (PyTorch port
of ``audiossl_tpu/methods/distill/train_other.py``; reference
``methods/atstframe/train_distill_other.py`` and
``module_distill_other.py``): a frozen finetuned ATST-Clip classifier
distilled into an ATST-Frame student on spcv2, nsynth, voxceleb1, ...,
with a central crop (12 s by default), cross-entropy (single-label) or
BCE (multi-label) losses mixed by ``lambda_d``, validation every epoch and
the test on the last state.

    python -m audiossl_tpu_torch.methods.distill.train_other \\
        --dataset_name spcv2 --data_path DATA \\
        --teacher_ckpt_path clip_classifier.ckpt \\
        --student_ckpt_path frame_pretrain.ckpt --save_path OUT \\
        [--arch base] [--device cpu]

The flags are JAX's, plus ``--device`` and ``--n_devices`` as in
``train.py``, whose checkpoint loading, saving and N-rank stepping this
driver shares; evaluation runs each rank's rows of a batch and gathers
them (``parallel.gather_rows``). Rank 0 alone prints, saves and writes
``result.json`` (dataset, val, test).
"""
from __future__ import annotations

import argparse
import functools
import json
import os
import time
from typing import Optional

import numpy as np

from audiossl_tpu_torch.datasets import get_dataset
from audiossl_tpu_torch.datasets.pipeline import BatchLoader
from audiossl_tpu_torch.downstream.metrics import Metric
from audiossl_tpu_torch.kernels.build import resolve_device
from audiossl_tpu_torch.methods.distill.method import DistillConfig, host_state
from audiossl_tpu_torch.methods.distill.train import (add_device_flags,
                                                      build_method, fit_epoch,
                                                      save_epoch)
from audiossl_tpu_torch.parallel.launch import print0, run_cli
from audiossl_tpu_torch.parallel.mesh import world
from audiossl_tpu_torch.training.checkpoint import CheckpointManager


def build_parser():
    p = argparse.ArgumentParser("train_distill_other")
    p.add_argument("--dataset_name", required=True)
    p.add_argument("--data_path", required=True)
    p.add_argument("--teacher_ckpt_path", required=True,
                   help="finetuned clip classifier (encoder+LinearHead)")
    p.add_argument("--student_ckpt_path", required=True,
                   help="pretrained FrameAST checkpoint")
    p.add_argument("--save_path", default=None)
    p.add_argument("--arch", default="base",
                   choices=["tiny", "small", "base"])
    p.add_argument("--lambda_d", type=float, default=0.5)
    p.add_argument("--learning_rate", type=float, default=5e-4)
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--max_epochs", type=int, default=40)
    p.add_argument("--warmup_epochs", type=int, default=2)
    p.add_argument("--layer_wise_lr", type=float, default=0.75)
    p.add_argument("--max_len", type=float, default=12.0,
                   help="CentralCrop seconds (DistillATSTTrainTransform)")
    add_device_flags(p)
    return p


def main(argv=None, record: Optional[dict] = None):
    """Distill on ``--n_devices`` ranks, validate every epoch, test the
    last state; -> the result dict (dataset, val, test), also printed and
    written to ``save_path/result.json``, or None where the ranks were
    started here. ``record`` (rank 0's), when given, receives ``steps``
    and ``saved`` (``train.fit_epoch``, ``train.save_epoch``) and
    ``evals`` (per evaluation, its split and (clips, seconds) per batch,
    loading included)."""
    return run_cli(functools.partial(train, record=record),
                   build_parser().parse_args(argv))


def train(args, record: Optional[dict] = None):
    """One rank's run (or the only one) of :func:`main`."""
    dev = resolve_device(args.device)
    if not world().is_main:
        record = None
    info = get_dataset(args.dataset_name)
    train_ds = info.creator(args.data_path, split="train")
    val_ds = info.creator(args.data_path, split="valid")
    test_ds = info.creator(args.data_path, split="test")
    pad = int(args.max_len * 16000)
    cfg = DistillConfig(
        arch=args.arch,
        num_labels=info.num_labels, lambda_d=args.lambda_d,
        learning_rate=args.learning_rate * args.batch_size / 256.0,
        max_epochs=args.max_epochs,
        steps_per_epoch=max(len(train_ds) // args.batch_size, 1),
        warmup_epochs=args.warmup_epochs,
        layer_wise_lr=args.layer_wise_lr,
        max_len=args.max_len,
        multi_label=info.multi_label,
        crop="central")
    method, state = build_method(cfg, args, dev)
    if record is not None:
        record["evals"] = []

    def eval_split(split, ds):
        m = Metric("mAP" if info.multi_label else "ACC")
        timings = []
        t0 = time.perf_counter()
        for batch in BatchLoader(ds, args.batch_size, pad_samples=pad,
                                 shuffle=False, drop_last=False):
            logits = method.eval_all(state, batch).cpu().numpy()
            if info.multi_label:
                logits = 1.0 / (1.0 + np.exp(-logits))
            m.update(logits, batch["label"])
            t1 = time.perf_counter()
            timings.append((len(logits), t1 - t0))
            t0 = t1
        if record is not None:
            record["evals"].append((split, timings))
        return m.compute()

    mgr = (CheckpointManager(os.path.join(args.save_path, "ckpt"),
                             to_host=host_state)
           if args.save_path else None)
    last_val, metrics = float("nan"), {}
    loader = BatchLoader(train_ds, args.batch_size, pad_samples=pad,
                         shuffle=True)
    for epoch in range(args.max_epochs):
        loader.set_epoch(epoch)
        state, metrics = fit_epoch(method, state, loader, record)
        last_val = eval_split("valid", val_ds)
        print0(f"epoch {epoch}: val={last_val:.4f} " + " ".join(
            f"{k}={float(v):.5g}" for k, v in sorted(metrics.items())),
            flush=True)
        save_epoch(mgr, state, record)
    # the reference tests from last.ckpt (train_distill_other.py:104-106)
    test = eval_split("test", test_ds)
    result = {"dataset": args.dataset_name, "val": last_val, "test": test}
    print0(json.dumps(result))
    if mgr is not None:
        mgr.close()
    if args.save_path and world().is_main:
        os.makedirs(args.save_path, exist_ok=True)
        with open(os.path.join(args.save_path, "result.json"), "w") as f:
            json.dump(result, f)
    return result


if __name__ == "__main__":
    main()
