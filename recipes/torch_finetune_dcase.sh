#!/bin/bash
# finetune_dcase.sh on the PyTorch port (audiossl_tpu_torch), flag for flag; the
# CLI runs on the card by default. The recipe it follows:
# DCASE SED finetune (reference shell/downtream/finetune_dcase/
# frame_atst.sh: lr 1e-1, mixed batch [128 synth, 128 weak],
# median window 7, 50 test thresholds).
CKPT=${1:?usage: torch_finetune_dcase.sh CKPT DCASE_DIR}
DATA=${2:?}
python -m audiossl_tpu_torch.downstream.train_dcase \
  --pretrained_ckpt_path "$CKPT" --data_path "$DATA" \
  --learning_rate 1e-1 --batch_size_synth 128 --batch_size_weak 128 \
  --median_window 7
