"""AudioSet-strong (407-class) SED finetuning driver (PyTorch port of
``audiossl_tpu/downstream/train_as_strong.py``; reference
``downstream/train_as_strong.py:26-186`` +
``utils_as_strong/model_as_strong.py:61-325``): strong-only batches, the
per-layer learning-rate decay 0.75, the validation strong BCE monitored in
"min" mode with early stopping after ``patience`` epochs without a better
one, and the test scored as ``train_dcase`` scores it.

    python -m audiossl_tpu_torch.downstream.train_as_strong \\
        --pretrained_ckpt_path last.ckpt --data_path AS_STRONG \\
        --save_path out [--arch base] [--device cpu]

``AS_STRONG`` holds ``common_labels.txt`` (one label a line) and
``train``, ``val`` and ``eval``, each with ``audio/`` and a ``meta.tsv``
(filename, onset, offset, event_label); ``eval/durations.tsv`` is
optional. The flags are JAX's, plus ``--device`` (default ``cuda``;
without a card that raises). ``--n_devices N`` runs N ranks as
``train_dcase`` does: each steps on its rows of the global batch with
every reduction global, evaluation is scored row by row over the ranks
and gathered, and rank 0 alone prints, keeps states and writes.
"""
from __future__ import annotations

import argparse
import functools
import os
from typing import Optional

import numpy as np
import torch

from audiossl_tpu_torch.datasets import get_dataset
from audiossl_tpu_torch.datasets.sed import (MixedBatchLoader, dcase_encoder,
                                             load_as_strong_labels)
from audiossl_tpu_torch.downstream.comparison_models import list_adapters
from audiossl_tpu_torch.downstream.train_dcase import (
    EVAL_B, SEED, SIZES, build_encoder, build_sed_teacher, evaluate_test,
    read_ground_truth, timed, train_epoch, write_result)
from audiossl_tpu_torch.downstream.train_finetune import (host_modules,
                                                          load_modules)
from audiossl_tpu_torch.kernels.build import resolve_device
from audiossl_tpu_torch.parallel.launch import add_n_devices, print0, run_cli
from audiossl_tpu_torch.parallel.mesh import world
from audiossl_tpu_torch.sed.decode import decode_preds
from audiossl_tpu_torch.sed.metrics import SEDMetrics
from audiossl_tpu_torch.sed.module import SEDConfig, SEDTask
from audiossl_tpu_torch.training.checkpoint import TopKKeeper


def evaluate_val_as_strong(predict, state, loader, median_window,
                           timings: Optional[list] = None):
    """The reference's AudioSet-strong validation (model_as_strong.py:
    140-161): the monitored ``val/object_metric`` is the mean strong BCE
    **loss** (min mode), computed on the host with numpy in f32 as JAX's;
    the intersection macro F1, decoded on the scores' device, is logged
    beside it. -> (loss, f1)."""
    sed = SEDMetrics(intersection_thd=0.5)
    losses = []
    for batch in timed(loader, timings):
        strong, _ = predict(state, batch)
        strong = torch.as_tensor(strong)
        host = strong.cpu().numpy()
        y = np.transpose(batch["strong"], (0, 2, 1))[..., :host.shape[-1]]
        p = np.clip(host, 1e-7, 1 - 1e-7)
        losses.append(float(-np.mean(y * np.log(p)
                                     + (1 - y) * np.log(1 - p))))
        sed.accumulate(decode_preds(strong, [0.5], median_window),
                       torch.as_tensor(y, device=strong.device))
    return (float(np.mean(losses)) if losses else float("inf"),
            sed.macro_f1())


def build_parser():
    p = argparse.ArgumentParser("train_as_strong")
    p.add_argument("--pretrained_ckpt_path", required=True)
    p.add_argument("--data_path", required=True)
    p.add_argument("--save_path", default=None)
    p.add_argument("--arch", default="base",
                   choices=list(SIZES) + list_adapters(),
                   help="own frame-AST size tier, or an encoder adapter "
                        "(reference train_as_strong.py dispatch)")
    p.add_argument("--learning_rate", type=float, default=1e-3)
    p.add_argument("--lr_scale", type=float, default=0.75)
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--max_epochs", type=int, default=100)
    p.add_argument("--warmup_epochs", type=int, default=5)
    p.add_argument("--patience", type=int, default=10)
    p.add_argument("--median_window", type=int, default=7)
    p.add_argument("--freeze_mode", action="store_true")
    p.add_argument("--save_top_k", type=int, default=3)
    # distill mode: a frozen finetuned AudioSet-strong teacher, total =
    # strong/2 + distill_strong/2 (reference utils_as_strong/
    # model_distill_as_strong.py:115-141)
    p.add_argument("--distill_ckpt", default=None,
                   help="teacher SED checkpoint: a previous run's "
                        "save_path or a directory holding state.pt; "
                        "enables distill mode")
    p.add_argument("--distill_arch", default="frameatst",
                   help="teacher encoder arch (size tier or adapter)")
    p.add_argument("--distill_pretrained_ckpt_path", default=None,
                   help="pretrained checkpoint the teacher encoder is "
                        "built from")
    p.add_argument("--distill_weight", type=float, default=1.0,
                   help="weight of the strong-distill term (1.0 = the "
                        "reference's strong/2 + d/2)")
    p.add_argument("--device", default="cuda",
                   help="device of the training and evaluation (raises "
                        "for cuda without a card)")
    add_n_devices(p)
    return p


def main(argv=None, record: Optional[dict] = None):
    """Finetune on ``--n_devices`` ranks with early stopping, test the
    best state; -> the result, also printed and written to
    ``save_path/result.json``, or None where the ranks were started here.
    ``record`` as ``train_dcase.main``'s."""
    return run_cli(functools.partial(train, record=record),
                   build_parser().parse_args(argv))


def train(args, record: Optional[dict] = None):
    """One rank's run (or the only one) of :func:`main`."""
    dev = resolve_device(args.device)
    if not world().is_main:
        record = None
    info = get_dataset("as_strong")
    enc, net_pooling = build_encoder(args.arch, args.pretrained_ckpt_path,
                                     dev)
    labels = load_as_strong_labels(
        os.path.join(args.data_path, "common_labels.txt"))
    encoder = dcase_encoder(net_pooling=net_pooling, labels=labels)
    train_ds = info.creator(args.data_path, split="train", encoder=encoder)
    val_ds = info.creator(args.data_path, split="valid", encoder=encoder)
    test_ds = info.creator(args.data_path, split="test", encoder=encoder)

    train_loader = MixedBatchLoader([train_ds], [args.batch_size])
    # the head's size follows the label list (407 for the published
    # common_labels.txt, as the registry states)
    teacher_fn = None
    if args.distill_ckpt:
        teacher_fn = build_sed_teacher(
            args.distill_ckpt, args.distill_arch,
            args.distill_pretrained_ckpt_path or args.pretrained_ckpt_path,
            len(labels), dev)
    cfg = SEDConfig(num_labels=len(labels),
                    learning_rate=args.learning_rate,
                    max_epochs=args.max_epochs,
                    steps_per_epoch=max(len(train_loader), 1),
                    warmup_epochs=args.warmup_epochs,
                    median_window=args.median_window,
                    lr_scale=args.lr_scale,
                    freeze_mode=args.freeze_mode,
                    distill_weight=(args.distill_weight
                                    if teacher_fn is not None else 0.0),
                    distill_combine="average_strong")
    task = SEDTask(enc, cfg, teacher_fn=teacher_fn,
                   generator=torch.Generator().manual_seed(SEED))
    state = task.init_state()
    gen = torch.Generator().manual_seed(SEED + 1)
    if record is not None:
        record.update(steps=[], evals=[])

    def eval_loader(ds):
        return MixedBatchLoader([ds], [EVAL_B], shuffle=False)

    # the reference monitors the validation strong loss in min mode,
    # save_top_k=3, with EarlyStopping(patience 10, min)
    # (train_as_strong.py:48-61)
    keeper = (TopKKeeper(args.save_path, k=args.save_top_k, mode="min")
              if args.save_path else None)
    best_obj, best_state, since = float("inf"), host_modules(state), 0
    for epoch in range(args.max_epochs):
        train_loader.set_epoch(epoch)
        times = [] if record is not None else None
        state, metrics = train_epoch(task, state, train_loader, gen, times)
        evals = [] if record is not None else None
        val_loss, f1 = evaluate_val_as_strong(
            task.predict_all, state, eval_loader(val_ds), cfg.median_window,
            evals)
        if record is not None:
            record["steps"].append(times)
            record["evals"].append(evals)
        print0(f"epoch {epoch}: val_loss={val_loss:.4f} "
               f"intersection_f1={f1:.4f} "
               f"loss={float(metrics['loss']):.4f}", flush=True)
        host = host_modules(state)
        if keeper is not None:
            keeper.update(val_loss, epoch, host)
        if val_loss < best_obj:
            best_obj, best_state, since = val_loss, host, 0
        else:
            since += 1
            if since >= args.patience:  # the reference's EarlyStopping
                print0(f"early stop at epoch {epoch}")
                break

    if record is not None:
        record["final"] = host_modules(state)
    gt, durations = read_ground_truth(os.path.join(args.data_path, "eval"),
                                      cfg.audio_len)
    if keeper is not None:
        restored = keeper.restore_best()
        if restored is not None:
            best_state = restored
    load_modules(state, best_state)
    result = evaluate_test(task, task.predict_all, state,
                           eval_loader(test_ds),
                           encoder, cfg, gt, durations,
                           None if record is None else
                           record.setdefault("test", {}))
    write_result(args.save_path, result)
    return result


if __name__ == "__main__":
    main()
