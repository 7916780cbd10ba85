"""ATST-Clip pretraining CLI (PyTorch port of
``audiossl_tpu/methods/atst/train.py``; reference ``atst_train`` console
script, ``methods/atst/train.py``): JAX's flags, plus ``--device`` (the
card by default; ``cpu`` runs the kernels' plain versions).

Example (reference train_small.sh recipe, as
``recipes/torch_atst_clip_small.sh`` runs it):
  python -m audiossl_tpu_torch.methods.atst.train \\
    --data_path /data/audioset --arch small --subset 200000 \\
    --batch_size_per_device 384 --learning_rate 5e-4 --ema 0.99 \\
    --max_steps 39010 --warmup_steps 1300 --save_path ./exp/atst_small
"""
from __future__ import annotations

import argparse

from audiossl_tpu_torch.datasets.packed import PackedAudioDataset
from audiossl_tpu_torch.methods.atst.method import (ClipMethod,
                                                    ClipPretrainConfig)
from audiossl_tpu_torch.parallel.launch import default_ranks, run_cli
from audiossl_tpu_torch.training.pretrain import OptimizerConfig
from audiossl_tpu_torch.training.runner import run_pretraining


def build_parser():
    p = argparse.ArgumentParser("atst_train")
    p.add_argument("--data_path", required=True,
                   help="directory with train.ards (+ .idx)")
    p.add_argument("--save_path", default=None)
    p.add_argument("--arch", default="small", choices=["tiny", "small", "base"])
    p.add_argument("--batch_size_per_device", type=int, default=384)
    p.add_argument("--learning_rate", type=float, default=5e-4)
    p.add_argument("--ema", type=float, default=0.99)
    p.add_argument("--warmup_steps", type=int, default=1300)
    p.add_argument("--max_steps", type=int, default=39010)
    p.add_argument("--subset", type=int, default=200000)
    p.add_argument("--anchor_len", type=float, nargs=2, default=[6.0, 6.0])
    p.add_argument("--positive_len", type=float, nargs=2,
                   default=[6.0, 6.0])
    p.add_argument("--virtual_crop", type=float, default=1.5)
    p.add_argument("--dtype", default="bfloat16")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--ckpt_interval", type=int, default=5000)
    p.add_argument("--n_devices", type=int, default=None,
                   help="data-parallel ranks, one a card (default: every "
                        "visible card, or the launcher's WORLD_SIZE; 1 "
                        "for --device cpu); without torchrun the CLI "
                        "starts them")
    p.add_argument("--profile_at", type=int, default=None,
                   help="capture a torch.profiler trace for 10 steps "
                        "starting at this step")
    p.add_argument("--shard_optimizer", action="store_true",
                   help="ZeRO-1: each rank keeps the Adam moments of "
                        "the parameters it owns")
    p.add_argument("--clip_len", type=float, default=10.0,
                   help="host buffer seconds (full clip length)")
    p.add_argument("--device", default="cuda",
                   help="torch device (cpu runs the kernels' plain "
                        "versions)")
    return p


def build_config(args) -> ClipPretrainConfig:
    """The config JAX's ``main`` builds from the same flags, over n ranks
    (the reference's lr scaling rule lr * nproc * bs / 256,
    train.py:12)."""
    n = args.n_devices or default_ranks(args.device)
    lr = args.learning_rate * n * args.batch_size_per_device / 256.0
    return ClipPretrainConfig(
        arch=args.arch,
        anchor_len=tuple(args.anchor_len),
        positive_len=tuple(args.positive_len),
        virtual_crop=args.virtual_crop,
        dtype=args.dtype,
        optimizer=OptimizerConfig(
            learning_rate=lr, warmup_steps=args.warmup_steps,
            max_steps=args.max_steps, ema=args.ema),
    )


def build_method(args) -> ClipMethod:
    """The method ``main`` trains: ``build_config(args)`` on
    ``args.device``, its weights drawn from ``args.seed``."""
    return ClipMethod(build_config(args), device=args.device,
                      seed=args.seed)


def main(argv=None):
    """Train on ``--n_devices`` ranks (``parallel.launch.run_cli``):
    returns the final state, or None where the ranks were started here."""
    return run_cli(train, build_parser().parse_args(argv))


def train(args):
    """One rank's run (or the only one): ``build_method(args)`` trained
    on the pack by ``run_pretraining``."""
    method = build_method(args)
    dataset = PackedAudioDataset(args.data_path, "train",
                                 subset=args.subset)
    return run_pretraining(
        method, dataset,
        batch_size_per_device=args.batch_size_per_device,
        max_steps=args.max_steps, save_path=args.save_path,
        ckpt_interval=args.ckpt_interval, seed=args.seed,
        n_devices=args.n_devices, clip_len_s=args.clip_len,
        profile_at=args.profile_at, shard_optimizer=args.shard_optimizer)


if __name__ == "__main__":
    main()
