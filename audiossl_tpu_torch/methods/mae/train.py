"""MAE pretraining CLI (PyTorch port of
``audiossl_tpu/methods/mae/train.py``; the reference's MAE method has no
training script): JAX's flags, plus ``--device`` (the card by default;
``cpu`` runs the kernels' plain versions).

Example:
  python -m audiossl_tpu_torch.methods.mae.train \\
    --data_path /data/audioset --subset 200000 \\
    --batch_size_per_device 256 --learning_rate 5e-4 \\
    --max_steps 39010 --warmup_steps 1300 --save_path ./exp/mae_small
"""
from __future__ import annotations

import argparse

from audiossl_tpu_torch.datasets.packed import PackedAudioDataset
from audiossl_tpu_torch.methods.mae.method import MAEConfig, MAEMethod
from audiossl_tpu_torch.parallel.launch import (add_n_devices, default_ranks,
                                                run_cli)
from audiossl_tpu_torch.training.pretrain import OptimizerConfig
from audiossl_tpu_torch.training.runner import run_pretraining


def build_parser():
    p = argparse.ArgumentParser("mae_train")
    p.add_argument("--data_path", required=True)
    p.add_argument("--save_path", default=None)
    p.add_argument("--batch_size_per_device", type=int, default=256)
    p.add_argument("--learning_rate", type=float, default=5e-4,
                   help="reference-batch-256 lr; scaled by "
                        "n_devices*batch/256")
    p.add_argument("--warmup_steps", type=int, default=1300)
    p.add_argument("--max_steps", type=int, default=39010)
    p.add_argument("--subset", type=int, default=200000)
    p.add_argument("--anchor_len", type=float, default=6.0)
    p.add_argument("--mask_ratio", type=float, default=0.75)
    p.add_argument("--embed_dim", type=int, default=384)
    p.add_argument("--depth", type=int, default=12)
    p.add_argument("--num_heads", type=int, default=6)
    p.add_argument("--dec_embed_dim", type=int, default=384)
    p.add_argument("--dec_depth", type=int, default=6)
    p.add_argument("--dec_num_heads", type=int, default=6)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--ckpt_interval", type=int, default=5000)
    add_n_devices(p)
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


def build_config(args) -> MAEConfig:
    """The config JAX's ``main`` builds from the same flags: lr =
    learning_rate * n * batch_size_per_device / 256 over n ranks."""
    n = args.n_devices or default_ranks(args.device)
    lr = args.learning_rate * n * args.batch_size_per_device / 256.0
    return MAEConfig(
        anchor_len=args.anchor_len,
        mask_ratio=args.mask_ratio,
        embed_dim=args.embed_dim,
        depth=args.depth,
        num_heads=args.num_heads,
        dec_embed_dim=args.dec_embed_dim,
        dec_depth=args.dec_depth,
        dec_num_heads=args.dec_num_heads,
        optimizer=OptimizerConfig(
            learning_rate=lr, warmup_steps=args.warmup_steps,
            max_steps=args.max_steps),
    )


def build_method(args) -> MAEMethod:
    """The method ``main`` trains: ``build_config(args)`` on
    ``args.device``, its weights drawn from ``args.seed``."""
    return MAEMethod(build_config(args), device=args.device, seed=args.seed)


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
