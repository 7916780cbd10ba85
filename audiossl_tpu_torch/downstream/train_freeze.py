"""Linear-probe driver (PyTorch port of ``audiossl_tpu/downstream/
train_freeze.py``; reference ``atst_downstream_train_freeze``,
``methods/atst/downstream/train_freeze.py`` and the atstframe variant).

Two phases, as in the reference: (1) extract embeddings once with the
frozen pretrained encoder (clip: the chunked CLS and mean of the last
blocks; frame: chunk-averaged scene embeddings), (2) train a linear head on
the in-memory cache, select by the validation metric and report the test
metric; datasets with folds (us8k) loop over them and average.

    python -m audiossl_tpu_torch.downstream.train_freeze \\
        --pretrained_ckpt_path last.ckpt --data_path DATA \\
        --dataset_name spcv2 --model_type clip --arch base [--device cpu]

The flags are JAX's, plus ``--device`` (default ``cuda``; without a card
that raises, it never falls back to the CPU). Extraction and the probe run
on that device, one batch at a time; the encoder is the plain f32 one (the
module route), as JAX's driver builds it, so the mel kernel K1 is the one
kernel on the path. Reference ``.ckpt`` files load, and the port's own
pretraining checkpoints (a ``state.pt`` or its step directory); an orbax
directory needs JAX to read, and the port imports none of it: its
``.ckpt`` export (``scripts/export_orbax_ckpt.py``) loads.

``--n_devices N`` (default: every visible card, 1 on the CPU; or
torchrun's ``WORLD_SIZE``) runs N ranks (``parallel.launch.run_cli``):
each extracts its rows of every batch (a ragged batch padded), the
embeddings are gathered on every rank, every rank trains the same probe
on them, and rank 0 alone writes ``result.json`` and the keepers (JAX's
driver writes from every process).
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

from audiossl_tpu_torch.compat.checkpoint import (
    load_encoder_state,
    load_pretrain_checkpoint,
    port_state_path,
)
from audiossl_tpu_torch.datasets import get_dataset
from audiossl_tpu_torch.datasets.pipeline import BatchLoader
from audiossl_tpu_torch.downstream.embedding import (
    extract_split,
    make_clip_extractor,
    make_frame_extractor,
)
from audiossl_tpu_torch.downstream.linear import (
    LinearProbeConfig,
    train_linear_probe,
)
from audiossl_tpu_torch.kernels.build import resolve_device
from audiossl_tpu_torch.models.atst import (
    ast_base,
    ast_small,
    ast_tiny,
    frame_ast_base,
    frame_ast_small,
    frame_ast_tiny,
)
from audiossl_tpu_torch.parallel.launch import add_n_devices, print0, run_cli
from audiossl_tpu_torch.parallel.mesh import replicated, world

_MAKERS = {
    ("clip", "tiny"): ast_tiny, ("clip", "small"): ast_small,
    ("clip", "base"): ast_base,
    ("frame", "tiny"): frame_ast_tiny, ("frame", "small"): frame_ast_small,
    ("frame", "base"): frame_ast_base,
}


def load_encoder(ckpt_path: str, model_type: str, arch: str,
                 spec_w: int = 1001, which: str = "teacher", device="cuda"):
    """-> the frozen f32 encoder (eval mode) on ``device`` with the
    ``which`` encoder of a reference ``.ckpt`` (either patch-embed layout;
    ``compat.checkpoint.encoder_state_from_torch``) or of one of the
    port's pretraining checkpoints (a ``state.pt`` or its step directory,
    loaded as it is, into an encoder with as many position embeddings as
    it holds, which the pretraining ``--anchor_len`` set; its arch, read
    off its shapes, must be ``model_type`` and ``arch``). Any other path
    raises ``NotImplementedError``: JAX reads orbax directories through
    orbax and tensorstore, which the port does not use
    (``scripts/export_orbax_ckpt.py`` writes their ``.ckpt``)."""
    device = resolve_device(device)
    if not (ckpt_path.endswith(".ckpt") or port_state_path(ckpt_path)):
        raise NotImplementedError(
            "only reference .ckpt files and the port's state.pt "
            "checkpoints load; orbax directories need JAX to read, which "
            "the port does not import: turn one into a .ckpt with "
            "scripts/export_orbax_ckpt.py where JAX and orbax are installed")
    sd, hparams = load_pretrain_checkpoint(ckpt_path, which=which)
    layout = hparams.get("layout", "reference")
    if layout == "port" and (hparams["model_type"], hparams["arch"]) != (
            model_type, arch):
        raise ValueError(
            f"{ckpt_path} holds a {hparams['model_type']} {hparams['arch']} "
            f"encoder, not the {model_type} {arch} asked for")
    # built on the meta device: the checkpoint's tensors are its weights
    enc = _MAKERS[(model_type, arch)](spec_w=spec_w, device="meta")
    if layout == "port" and sd["pos_embed"].shape != enc.pos_embed.shape:
        # the position embeddings of the pretraining crop (the port's CLIs
        # size them by --anchor_len): an encoder of that length
        rows = enc.spec_h // enc.patch_h
        cols = (sd["pos_embed"].shape[1] - 1) // rows
        enc = _MAKERS[(model_type, arch)](spec_w=cols * enc.patch_w + 1,
                                          device="meta")
    load_encoder_state(enc, sd, assign=True, layout=layout)
    enc.requires_grad_(False)
    # the checkpoint's dtype came with assign=True: cast, as load_model does
    return enc.to(device, torch.float32).eval()


def run_fold(extract, info, args, fold: int,
             record: Optional[dict] = None):
    """Extract the three splits of one fold, train the probe; -> (val,
    test). ``record``, when given, receives under ``fold`` each split's
    (embeddings, labels), its per-batch extraction (clips, seconds), the
    probe's seconds and its best head's state dict (``state``)."""
    def loader(split):
        kw = dict(fold=fold) if info.num_folds > 1 else {}
        ds = info.creator(args.data_path, split=split, **kw)
        return BatchLoader(ds, args.batch_size,
                           pad_samples=int(args.train_len * 16000),
                           shuffle=False, drop_last=False)

    cache, timings = {}, {}
    for split in ("train", "valid", "test"):
        timings[split] = []
        cache[split] = extract_split(extract, loader(split), timings[split])
    (train_e, train_y), (val_e, val_y), (test_e, test_y) = (
        cache["train"], cache["valid"], cache["test"])

    cfg = LinearProbeConfig(
        learning_rate=args.learning_rate,
        batch_size=args.batch_size,
        max_epochs=args.max_epochs,
        multi_label=info.multi_label,
        num_labels=info.num_labels,
        lr_scale=args.batch_size / 256.0,  # reference lr rule
    )
    keeper = None
    if args.save_path:
        from audiossl_tpu_torch.training.checkpoint import TopKKeeper

        keeper = TopKKeeper(os.path.join(args.save_path, f"fold{fold}"))
    t0 = time.perf_counter()
    with replicated():  # every rank trains the same probe, as one process
        res = train_linear_probe(train_e, train_y, val_e, val_y, test_e,
                                 test_y, cfg, keeper=keeper,
                                 device=args.device)
    if record is not None:
        record[fold] = {"embeddings": cache, "timings": timings,
                        "probe_s": time.perf_counter() - t0,
                        "state": {k: v.cpu() for k, v in
                                  res["state"].items()}}
    return res["val_metric"], res["test_metric"]


def build_parser():
    p = argparse.ArgumentParser("atst_downstream_train_freeze")
    p.add_argument("--pretrained_ckpt_path", required=True)
    p.add_argument("--data_path", required=True)
    p.add_argument("--dataset_name", required=True)
    p.add_argument("--save_path", default=None)
    p.add_argument("--model_type", default="clip",
                   choices=["clip", "frame"])
    p.add_argument("--arch", default="small",
                   choices=["tiny", "small", "base"])
    p.add_argument("--use_encoder", default="teacher",
                   choices=["teacher", "student"])
    p.add_argument("--learning_rate", type=float, default=2e-3)
    p.add_argument("--batch_size", type=int, default=1024)
    p.add_argument("--max_epochs", type=int, default=100)
    p.add_argument("--n_last_blocks", type=int, default=12)
    p.add_argument("--train_len", type=float, default=12.0,
                   help="central-crop seconds for downstream inputs")
    p.add_argument("--chunk_len_s", type=float, default=6.0,
                   help="frame-model chunk length (pretrain anchor_len)")
    p.add_argument("--device", default="cuda",
                   help="device of the extraction and the probe (raises "
                        "for cuda without a card)")
    add_n_devices(p)
    return p


def main(argv=None, record: Optional[dict] = None):
    """Run the probe on ``--n_devices`` ranks (``parallel.launch.run_cli``);
    -> the result dict also printed and written to
    ``save_path/result.json`` (dataset, metric, val, test, folds), or
    None where the ranks were started here. ``record`` (rank 0's): see
    :func:`run_fold`."""
    return run_cli(functools.partial(train, record=record),
                   build_parser().parse_args(argv))


def train(args, record: Optional[dict] = None):
    """One rank's run (or the only one) of :func:`main`."""
    resolve_device(args.device)
    if not world().is_main:
        record = None
    info = get_dataset(args.dataset_name)
    spec_w = int(args.chunk_len_s * 16000) // 160 + 1 \
        if args.model_type == "frame" else 1001
    enc = load_encoder(args.pretrained_ckpt_path, args.model_type,
                       args.arch, spec_w=spec_w, which=args.use_encoder,
                       device=args.device)
    if args.model_type == "clip":
        extract = make_clip_extractor(enc, crop_len_s=args.train_len,
                                      n_blocks=args.n_last_blocks)
    else:
        extract = make_frame_extractor(enc, crop_len_s=args.train_len,
                                       n_blocks=args.n_last_blocks,
                                       chunk_len_s=args.chunk_len_s)

    vals, tests = [], []
    for fold in range(info.num_folds):
        v, t = run_fold(extract, info, args, fold, record)
        vals.append(v)
        tests.append(t)
        print0(f"fold {fold}: val={v:.4f} test={t:.4f}", flush=True)
    result = {
        "dataset": args.dataset_name,
        "metric": "mAP" if info.multi_label else "ACC",
        "val": float(np.mean(vals)),
        "test": float(np.mean(tests)),
        "folds": len(vals),
    }
    print0(json.dumps(result))
    if args.save_path and world().is_main:
        os.makedirs(args.save_path, exist_ok=True)
        with open(os.path.join(args.save_path, "result.json"), "w") as f:
            json.dump(result, f)
    return result


if __name__ == "__main__":
    main()
