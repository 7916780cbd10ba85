#!/bin/bash
# finetune_as_strong.sh on the PyTorch port (audiossl_tpu_torch), flag for flag; the
# CLI runs on the card by default. The recipe it follows:
# AudioSet-strong SED finetune (reference finetune_frame_atst.bash:
# lr 1e-3, lr_scale 0.75, 100 epochs, early stop patience 10).
CKPT=${1:?usage: torch_finetune_as_strong.sh CKPT AS_STRONG_DIR}
DATA=${2:?}
python -m audiossl_tpu_torch.downstream.train_as_strong \
  --pretrained_ckpt_path "$CKPT" --data_path "$DATA" \
  --learning_rate 1e-3 --lr_scale 0.75 --max_epochs 100 --patience 10
