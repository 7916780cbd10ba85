#!/bin/bash
# finetune_dcase_arch.sh on the PyTorch port (audiossl_tpu_torch), flag for flag; the
# CLI runs on the card by default. The recipe it follows:
# DCASE SED finetune across comparison encoders (reference
# shell/downtream/finetune_dcase/*.sh: lr 1e-1, batch [128 synth,
# 128 weak], 100 epochs, median window 7). arch is an adapter name
# from the comparison-model registry (frameatst/clipatst/distillatst/
# beats) or an own-family size tier.
#
# usage: torch_finetune_dcase_arch.sh ARCH CKPT DCASE_DIR [LR]
set -e
ARCH=${1:?usage: torch_finetune_dcase_arch.sh ARCH CKPT DCASE_DIR [LR]}
CKPT=${2:?}
DATA=${3:?}
LR=${4:-1e-1}
python -m audiossl_tpu_torch.downstream.train_dcase \
  --pretrained_ckpt_path "$CKPT" --data_path "$DATA" \
  --arch "$ARCH" --learning_rate "$LR" \
  --batch_size_synth 128 --batch_size_weak 128 \
  --max_epochs 100 --warmup_epochs 10 --median_window 7
