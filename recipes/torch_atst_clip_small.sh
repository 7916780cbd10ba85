#!/bin/bash
# ATST-Clip SMALL pretraining on one GPU with the PyTorch port: the flags
# of atst_clip_small.sh (reference methods/atst/train_small.sh: bs 384 per
# device, lr 5e-4, ema 0.99, 39,100 steps, warmup 1,300, subset 200k, 9 s
# crops), bf16 by default. lr is scaled lr*devices*bs/256 by the CLI.
DATA=${1:?usage: torch_atst_clip_small.sh AUDIOSET_ARDS_DIR [SAVE]}
SAVE=${2:-./exp/atst_small}
python -m audiossl_tpu_torch.methods.atst.train \
  --data_path "$DATA" --save_path "$SAVE" \
  --arch small --subset 200000 \
  --batch_size_per_device 384 \
  --learning_rate 5e-4 --ema 0.99 \
  --warmup_steps 1300 --max_steps 39010 \
  --anchor_len 9.0 9.0 --positive_len 9.0 9.0
