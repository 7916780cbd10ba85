#!/bin/bash
# eval_freeze_iemocap.sh on the PyTorch port (audiossl_tpu_torch), flag for flag; the
# CLI runs on the card by default. The recipe it follows:
# Linear probe on iemocap (reference shell/downtream/freeze defaults:
# lr 2e-3, bs 1024, n_last_blocks 12; multi-fold datasets loop folds).
CKPT=${1:?usage: torch_eval_freeze_iemocap.sh CKPT DATA_DIR [clip|frame]}
DATA=${2:?}
TYPE=${3:-clip}
python -m audiossl_tpu_torch.downstream.train_freeze \
  --pretrained_ckpt_path "$CKPT" --data_path "$DATA" \
  --dataset_name iemocap --model_type "$TYPE" \
  --learning_rate 2e-3 --batch_size 1024 --n_last_blocks 12
