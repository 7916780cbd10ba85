"""DCASE SED finetuning driver (PyTorch port of
``audiossl_tpu/downstream/train_dcase.py``; reference
``downstream/train_dcase.py:26-175`` + ``utils_dcase/model_dcase.py``).

Trains on mixed strong-synthetic / weak batches, monitors the intersection
F1 + weak F1 objective every epoch, keeps the best states, and scores the
test split from the best with PSDS scenario 1 (dtc / gtc 0.7) and scenario
2 (0.1 / 0.1, cttc 0.3, alpha_ct 0.5) over 50 operating points, plus the
collar event F1 at 0.5.

    python -m audiossl_tpu_torch.downstream.train_dcase \\
        --pretrained_ckpt_path last.ckpt --data_path DCASE \\
        --save_path out [--arch base] [--device cpu]

The flags are JAX's, plus ``--device`` (default ``cuda``; without a card
that raises, it never falls back to the CPU). ``DCASE`` holds
``synth_train``, ``weak_train``, ``synth_val`` and ``strong_val``, each
with ``audio/`` and a ``meta.tsv`` (``datasets/sed.py``);
``strong_val/durations.tsv`` (filename, duration) is optional. The encoder
is ``train_freeze.load_encoder``'s (the f32 module route: K1 is the one
kernel on the path) or an adapter of ``comparison_models``: the
repository's own, or one of the eight comparison encoders read from its
authors' checkpoint (``--arch beats``, ``maeast``, ...; MAE-AST's
attention runs K6); the TSVs are read without pandas. Each step's
drop-path uniforms come from a seeded ``torch.Generator`` on the host
(the comparison encoders take none).

``--n_devices N`` (default: every visible card, 1 on the CPU; or
torchrun's ``WORLD_SIZE``) runs N ranks (``parallel.launch.run_cli``), as
JAX's ``downstream_spmd``: every rank reads the whole global batch (its
WAV files too) and draws the same uniforms, steps on its rows (a batch
whose rows do not divide runs whole on every rank) with every count, mean
and gradient global, scores its rows of each evaluation batch and
receives all of them (``SEDTask.predict_all``), so the decoding and the
metrics are the same on every rank; rank 0 alone prints, keeps states and
writes ``result.json``.
"""
from __future__ import annotations

import argparse
import functools
import json
import math
import os
import time
from typing import Optional

import numpy as np
import torch

from audiossl_tpu_torch.datasets import get_dataset
from audiossl_tpu_torch.datasets.sed import (MixedBatchLoader, dcase_encoder,
                                             read_tsv)
from audiossl_tpu_torch.downstream.comparison_models import (EncoderAdapter,
                                                             get_adapter,
                                                             list_adapters)
from audiossl_tpu_torch.downstream.train_finetune import (host_modules,
                                                          load_modules)
from audiossl_tpu_torch.downstream.train_freeze import load_encoder
from audiossl_tpu_torch.kernels.build import resolve_device
from audiossl_tpu_torch.models.atst import AudioTransformer
from audiossl_tpu_torch.parallel.launch import add_n_devices, print0, run_cli
from audiossl_tpu_torch.parallel.mesh import batch_rows, world
from audiossl_tpu_torch.sed.decode import batched_decode_preds, decode_preds
from audiossl_tpu_torch.sed.head import SEDHead
from audiossl_tpu_torch.sed.metrics import SEDMetrics, WeakF1Accumulator
from audiossl_tpu_torch.sed.module import SEDConfig, SEDTask
from audiossl_tpu_torch.sed.psds import (compute_psds, event_based_f1,
                                         event_table)
from audiossl_tpu_torch.training.checkpoint import (STATE_FILE, TopKKeeper,
                                                    read_topk_index)

SEED = 0  # the head's weights and the drop-path draws
SIZES = ("tiny", "small", "base")
EVAL_B = 32
N_TEST_THRESHOLDS = 50  # the test's operating points (reference: 50)
AUDIO_LEN = 10.0  # seconds a clip: the SED sets pad or cut to it


def timed(loader, out: Optional[list]):
    """The loader's batches; appends each one's (clips, seconds, seconds
    of loading), the caller's work on it included in the seconds, to
    ``out`` (when not None)."""
    batches = iter(loader)
    while True:
        t0 = time.perf_counter()
        batch = next(batches, None)
        if batch is None:
            return
        t1 = time.perf_counter()
        yield batch
        if out is not None:
            out.append((len(batch["wav"]), time.perf_counter() - t0,
                        t1 - t0))


def _labels(batch, T: int) -> np.ndarray:
    """The batch's strong labels [B, C, T] cut to T frames."""
    return np.transpose(batch["strong"], (0, 2, 1))[..., :T]


def evaluate_val(task, predict, state, synth_loader, weak_loader,
                 median_window, timings: Optional[list] = None):
    """The reference's validation objective (utils_dcase/model_dcase.py:
    175-232): the intersection macro F1 on the synthetic validation clips'
    strong labels, decoded on the scores' device, and the weak macro F1
    (torchmetrics multilabel, threshold 0.5) on the weak validation clips'
    labels. ``predict(state, batch) -> (strong, weak)``. -> (f1, weak F1)."""
    sed = SEDMetrics(intersection_thd=0.5)
    for batch in timed(synth_loader, timings):
        strong, _ = predict(state, batch)
        strong = torch.as_tensor(strong)
        y = torch.as_tensor(_labels(batch, strong.shape[-1]),
                            device=strong.device)
        sed.accumulate(decode_preds(strong, [0.5], median_window), y)
    f1 = sed.macro_f1()

    weak_f1 = WeakF1Accumulator()
    for batch in timed(weak_loader, timings):
        strong, weak = predict(state, batch)
        y = _labels(batch, strong.shape[-1])
        weak_f1.accumulate(torch.as_tensor(weak).cpu().numpy(),
                           (y.sum(-1) > 0).astype(np.float32))
    return f1, weak_f1.macro_f1()


def evaluate_test(task, predict, state, loader, encoder, cfg, ground_truth,
                  durations, record: Optional[dict] = None):
    """PSDS scenarios 1 and 2 over ``N_TEST_THRESHOLDS`` operating
    points and the event F1 at 0.5 of the loader's clips. ``record``, when
    given, receives ``decode_s`` (the decoding, the scores' host copies
    and event extraction), ``psds_s`` (the scoring) and ``strong`` (each
    batch's scores, kept only then)."""
    thds = np.arange(1 / (N_TEST_THRESHOLDS * 2), 1, 1 / N_TEST_THRESHOLDS)
    dets = {t: [] for t in thds}
    d05 = []
    decode_s, scores = 0.0, []
    for batch in loader:
        fnames = batch["filenames"]
        strong, _ = predict(state, batch)
        t0 = time.perf_counter()
        for t, ev in batched_decode_preds(
                strong, fnames, encoder, thresholds=list(thds),
                median_filter=cfg.median_window).items():
            dets[t] += ev
        d05 += batched_decode_preds(strong, fnames, encoder,
                                    thresholds=[0.5],
                                    median_filter=cfg.median_window)[0.5]
        decode_s += time.perf_counter() - t0
        if record is not None:
            scores.append(strong)
    t0 = time.perf_counter()
    psds1 = compute_psds(dets, ground_truth, durations,
                         dtc_threshold=0.7, gtc_threshold=0.7,
                         alpha_ct=0.0, alpha_st=1.0)
    psds2 = compute_psds(dets, ground_truth, durations,
                         dtc_threshold=0.1, gtc_threshold=0.1,
                         cttc_threshold=0.3, alpha_ct=0.5, alpha_st=1.0)
    ef1 = event_based_f1(d05, ground_truth)
    if record is not None:
        record.update(decode_s=decode_s, psds_s=time.perf_counter() - t0,
                      strong=scores)
    return {"psds1": psds1, "psds2": psds2, "event_f1": ef1}


def read_ground_truth(split_dir: str):
    """``meta.tsv`` as an event table, and ``durations.tsv`` (every file
    ``AUDIO_LEN`` seconds when there is none)."""
    rows = read_tsv(os.path.join(split_dir, "meta.tsv"))

    def num(x):
        return float(x) if x not in (None, "") else math.nan

    gt = event_table([(r.get("event_label"), num(r.get("onset")),
                       num(r.get("offset")), r["filename"]) for r in rows])
    path = os.path.join(split_dir, "durations.tsv")
    if os.path.exists(path):
        d = read_tsv(path)
        return gt, {"filename": [r["filename"] for r in d],
                    "duration": [float(r["duration"]) for r in d]}
    files = list(dict.fromkeys(gt["filename"]))
    return gt, {"filename": files, "duration": [AUDIO_LEN] * len(files)}


def build_encoder(arch: str, ckpt_path: str, device):
    """-> (the encoder, or an adapter of ``comparison_models``, and its
    frames' pooling of the 10 ms mel frames)."""
    if arch in SIZES:
        enc = load_encoder(ckpt_path, "frame", arch, spec_w=1001,
                           device=device)
        return enc, enc.patch_w
    adapter = get_adapter(arch, ckpt_path=ckpt_path, device=device)
    return adapter, adapter.frame_rate_divisor


def build_parser():
    p = argparse.ArgumentParser("train_dcase")
    p.add_argument("--pretrained_ckpt_path", required=True)
    p.add_argument("--data_path", required=True)
    p.add_argument("--save_path", default=None)
    p.add_argument("--arch", default="base",
                   choices=list(SIZES) + list_adapters(),
                   help="own frame-AST size tier, or an encoder adapter "
                        "(reference train_dcase.py:139-175 dispatch)")
    p.add_argument("--learning_rate", type=float, default=1e-1)
    p.add_argument("--batch_size_synth", type=int, default=128)
    p.add_argument("--batch_size_weak", type=int, default=128)
    p.add_argument("--max_epochs", type=int, default=100)
    p.add_argument("--warmup_epochs", type=int, default=10)
    p.add_argument("--median_window", type=int, default=7)
    p.add_argument("--freeze_mode", action="store_true")
    p.add_argument("--save_top_k", type=int, default=3)
    # distill mode: a frozen finetuned SED teacher added to the loss
    # (reference utils_dcase/model_distill.py + train_dcase.py:59-71)
    p.add_argument("--distill_ckpt", default=None,
                   help="teacher SED checkpoint: a previous run's "
                        "save_path (the best of top/) or a directory "
                        "holding state.pt; enables distill mode")
    p.add_argument("--distill_arch", default="frameatst",
                   help="teacher encoder arch (size tier or adapter "
                        "name, like --arch)")
    p.add_argument("--distill_pretrained_ckpt_path", default=None,
                   help="pretrained checkpoint the teacher encoder is "
                        "built from (the teacher's --pretrained_ckpt_path)")
    p.add_argument("--distill_weight", type=float, default=1.0,
                   help="weight of the teacher BCE term; 1.0 = the "
                        "reference's tot/2 + loss_d/2 ratio")
    p.add_argument("--device", default="cuda",
                   help="device of the training and evaluation (raises "
                        "for cuda without a card)")
    add_n_devices(p)
    return p


def build_sed_teacher(sed_ckpt: str, arch: str, pretrained_ckpt: str,
                      num_labels: int, device="cuda"):
    """A frozen finetuned SED teacher -> ``teacher_fn(wav, valid) ->
    (strong probabilities [B, C, T], weak [B, C])`` (reference
    utils_dcase/model_distill.py:163-174). ``sed_ckpt`` is the
    ``save_path`` of a ``train_dcase`` or ``train_as_strong`` run, whose
    best kept state is read by the keeper's mode, or a directory holding a
    ``state.pt``."""
    enc, _ = build_encoder(arch, pretrained_ckpt, device)
    adapter = EncoderAdapter(enc) if isinstance(enc, AudioTransformer) \
        else enc
    index_path = os.path.join(sed_ckpt, "top", "index.json")
    if os.path.exists(index_path):
        # the BEST entry by the keeper's mode (AudioSet-strong keeps the
        # validation loss, mode "min")
        index, mode = read_topk_index(index_path)
        tag = (max if mode == "max" else min)(index, key=index.__getitem__)
        path = os.path.join(sed_ckpt, "top", str(tag), STATE_FILE)
    else:
        path = os.path.join(sed_ckpt, STATE_FILE)
    saved = torch.load(path, map_location="cpu", weights_only=True)
    adapter.encoder.load_state_dict(saved["encoder"])
    adapter.encoder.requires_grad_(False).eval()
    head = SEDHead(adapter.embed_dim, num_labels, device=device)
    head.load_state_dict(saved["head"])
    head.requires_grad_(False)

    @torch.no_grad()
    def teacher_fn(wav, valid):
        return head(adapter.frame_embeddings(wav, valid))

    return teacher_fn


def train_epoch(task, state, loader, gen, times: Optional[list]):
    """One epoch of steps, each on this rank's rows of the loader's global
    batch (``parallel.batch_rows``) with the global batch's draws; ->
    (state, the last step's metrics). With ``times``, each step waits for
    its loss and appends its (clips, seconds, loading seconds)
    (:func:`timed`)."""
    metrics = {}
    for batch in timed(loader, times):
        dp = task.draw(gen, len(batch["wav"]))
        with batch_rows(batch) as rows:
            state, metrics = task.train_step(state, rows, dp)
        if times is not None:
            float(metrics["loss"])  # waits for the device
    return state, metrics


def write_result(save_path: Optional[str], result: dict) -> None:
    """Print ``result`` and write it to ``save_path/result.json``, on rank
    0 alone."""
    print0(json.dumps(result))
    if save_path and world().is_main:
        os.makedirs(save_path, exist_ok=True)
        with open(os.path.join(save_path, "result.json"), "w") as f:
            json.dump(result, f)


def main(argv=None, record: Optional[dict] = None):
    """Finetune on ``--n_devices`` ranks (``parallel.launch.run_cli``),
    validate every epoch, test the best state; -> the result (psds1,
    psds2, event_f1), also printed and written to
    ``save_path/result.json``, or None where the ranks were started here.
    ``record``, when given (rank 0's), receives ``steps``
    (per epoch, each step's (clips, seconds to its loss on the host, the
    batch's loading in them): only then does each step wait for the
    device), ``evals`` (per validation, each batch's (clips, seconds,
    loading seconds)), ``final`` (the trained modules after the last
    epoch, on the host) and ``test`` (:func:`evaluate_test`'s record)."""
    return run_cli(functools.partial(train, record=record),
                   build_parser().parse_args(argv))


def train(args, record: Optional[dict] = None):
    """One rank's run (or the only one) of :func:`main`."""
    dev = resolve_device(args.device)
    if not world().is_main:
        record = None
    info = get_dataset("dcase")
    enc, net_pooling = build_encoder(args.arch, args.pretrained_ckpt_path,
                                     dev)
    encoder = dcase_encoder(net_pooling=net_pooling)
    synth, weak = info.creator(args.data_path, split="train",
                               encoder=encoder)
    synth_val, weak_val = info.creator(args.data_path, split="valid",
                                       encoder=encoder)
    test_ds = info.creator(args.data_path, split="test", encoder=encoder)

    # the epoch's length is the weak set's (batch_len_index: 1, reference
    # conf/frame_40.yaml)
    train_loader = MixedBatchLoader(
        [synth, weak], [args.batch_size_synth, args.batch_size_weak],
        mode=1)
    teacher_fn = None
    if args.distill_ckpt:
        teacher_fn = build_sed_teacher(
            args.distill_ckpt, args.distill_arch,
            args.distill_pretrained_ckpt_path or args.pretrained_ckpt_path,
            info.num_labels, dev)
    cfg = SEDConfig(num_labels=info.num_labels,
                    learning_rate=args.learning_rate,
                    max_epochs=args.max_epochs,
                    steps_per_epoch=max(len(train_loader), 1),
                    warmup_epochs=args.warmup_epochs,
                    median_window=args.median_window,
                    freeze_mode=args.freeze_mode,
                    distill_weight=(args.distill_weight
                                    if args.distill_ckpt else 0.0))
    task = SEDTask(enc, cfg, teacher_fn=teacher_fn,
                   generator=torch.Generator().manual_seed(SEED))
    state = task.init_state()
    gen = torch.Generator().manual_seed(SEED + 1)
    if record is not None:
        record.update(steps=[], evals=[])

    def eval_loader(ds):
        return MixedBatchLoader([ds], [EVAL_B], shuffle=False)

    keeper = (TopKKeeper(args.save_path, k=args.save_top_k)
              if args.save_path else None)
    best_obj, best_state = -1.0, host_modules(state)
    for epoch in range(args.max_epochs):
        train_loader.set_epoch(epoch)
        times = [] if record is not None else None
        state, metrics = train_epoch(task, state, train_loader, gen, times)
        evals = [] if record is not None else None
        f1, weak_f1 = evaluate_val(task, task.predict_all, state,
                                   eval_loader(synth_val),
                                   eval_loader(weak_val), cfg.median_window,
                                   evals)
        if record is not None:
            record["steps"].append(times)
            record["evals"].append(evals)
        obj = f1 + weak_f1
        print0(f"epoch {epoch}: intersection_f1={f1:.4f} weak_F1="
               f"{weak_f1:.4f} loss={float(metrics['loss']):.4f}",
               flush=True)
        if obj > best_obj or keeper is not None:
            host = host_modules(state)
        if obj > best_obj:
            best_obj, best_state = obj, host
        if keeper is not None:
            keeper.update(obj, epoch, host)

    if record is not None:
        record["final"] = host_modules(state)
    # the test: PSDS needs the ground-truth events and the durations
    gt, durations = read_ground_truth(
        os.path.join(args.data_path, "strong_val"))
    if keeper is not None:
        # the test runs on the kept best state (the reference tests the
        # ModelCheckpoint-monitored best, train_dcase.py:51-58)
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
