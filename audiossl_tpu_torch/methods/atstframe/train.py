"""ATST-Frame pretraining CLI (PyTorch port of
``audiossl_tpu/methods/atstframe/train.py``; reference
``methods/atstframe/train.py``): JAX's flags, plus ``--device`` (the card
by default; ``cpu`` runs the kernels' plain versions).

Example (reference train_base.sh recipe, as
``recipes/torch_atst_frame_base.sh`` runs it):
  python -m audiossl_tpu_torch.methods.atstframe.train \\
    --data_path /data/audioset --arch base --subset 3000000 \\
    --batch_size_per_device 144 --learning_rate 8e-5 --ema 0.9996 \\
    --max_steps 398000 --warmup_steps 19900 --mask_type block \\
    --mask_ratio 0.65 --mask_len 5 --anchor_len 10 \\
    --aug_tea false --aug_stu true --save_path ./exp/atstframe_base
"""
from __future__ import annotations

import argparse

from audiossl_tpu_torch.datasets.packed import PackedAudioDataset
from audiossl_tpu_torch.methods.atstframe.method import (FrameMethod,
                                                         FramePretrainConfig)
from audiossl_tpu_torch.parallel.launch import default_ranks, run_cli
from audiossl_tpu_torch.training.pretrain import OptimizerConfig
from audiossl_tpu_torch.training.runner import run_pretraining
from audiossl_tpu_torch.utils.common import bool_flag


def build_parser():
    p = argparse.ArgumentParser("atstframe_train")
    p.add_argument("--data_path", required=True)
    p.add_argument("--save_path", default=None)
    p.add_argument("--arch", default="small", choices=["tiny", "small", "base"])
    p.add_argument("--batch_size_per_device", type=int, default=256)
    p.add_argument("--learning_rate", type=float, default=4e-4)
    p.add_argument("--ema", type=float, default=0.997)
    p.add_argument("--warmup_steps", type=int, default=1950)
    p.add_argument("--max_steps", type=int, default=58500)
    p.add_argument("--subset", type=int, default=3000000)
    p.add_argument("--anchor_len", type=float, default=10.0)
    p.add_argument("--symmetric", type=bool_flag, default=True)
    p.add_argument("--aug_tea", type=bool_flag, default=False)
    p.add_argument("--aug_stu", type=bool_flag, default=True)
    p.add_argument("--mix_up", type=bool_flag, default=True)
    p.add_argument("--freq_wrap", type=bool_flag, default=True)
    p.add_argument("--mask_type", default="block",
                   choices=["random", "block", "uniform"])
    p.add_argument("--mask_ratio", type=float, default=0.65)
    p.add_argument("--mask_len", type=int, default=5)
    p.add_argument("--min_mask_len", type=int, default=2)
    p.add_argument("--pos_type", default="cut",
                   choices=["cut", "interpolate"])
    p.add_argument("--avg_blocks", type=int, default=0)
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
    p.add_argument("--teacher_quant", default="none",
                   choices=["none", "int8"],
                   help="int8: the no-grad teacher's products in int8 "
                        "(K2q/K3q) - an opt-in recipe change")
    p.add_argument("--student_quant", default="none",
                   choices=["none", "int8", "int8dx"],
                   help="int8: the student's forward products in int8 "
                        "(straight-through backward); int8dx also its "
                        "grad-to-input products - opt-in")
    p.add_argument("--clip_len", type=float, default=10.0,
                   help="host buffer seconds (full clip length)")
    p.add_argument("--device", default="cuda",
                   help="torch device (cpu runs the kernels' plain "
                        "versions)")
    return p


def build_config(args) -> FramePretrainConfig:
    """The config JAX's ``main`` builds from the same flags: lr =
    learning_rate * n * batch_size_per_device / 256 over n ranks (the
    reference's lr * nproc * bs / 256)."""
    n = args.n_devices or default_ranks(args.device)
    lr = args.learning_rate * n * args.batch_size_per_device / 256.0
    return FramePretrainConfig(
        arch=args.arch,
        anchor_len=args.anchor_len,
        symmetric=args.symmetric,
        aug_tea=args.aug_tea,
        aug_stu=args.aug_stu,
        mix_up=args.mix_up,
        freq_wrap=args.freq_wrap,
        mask_type=args.mask_type,
        mask_ratio=args.mask_ratio,
        mask_len=args.mask_len,
        min_mask_len=args.min_mask_len,
        pos_type=args.pos_type,
        avg_blocks=args.avg_blocks,
        dtype=args.dtype,
        teacher_quant=args.teacher_quant,
        student_quant=args.student_quant,
        optimizer=OptimizerConfig(
            learning_rate=lr, warmup_steps=args.warmup_steps,
            max_steps=args.max_steps, ema=args.ema),
    )


def build_method(args) -> FrameMethod:
    """The method ``main`` trains: ``build_config(args)`` on
    ``args.device``, its weights drawn from ``args.seed``."""
    return FrameMethod(build_config(args), device=args.device,
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
