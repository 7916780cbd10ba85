#!/bin/bash
# ATST-Frame BASE pretraining on one GPU with the PyTorch port: the flags
# of atst_frame_base.sh (reference methods/atstframe/train_base.sh: bs 144
# per device, lr 8e-5, ema 0.9996, 398k steps, warmup 19,900, mask block
# 0.65 len 5, 10 s anchor, student-side aug only), bf16 by default.
DATA=${1:?usage: torch_atst_frame_base.sh AUDIOSET_ARDS_DIR [SAVE]}
SAVE=${2:-./exp/atstframe_base}
python -m audiossl_tpu_torch.methods.atstframe.train \
  --data_path "$DATA" --save_path "$SAVE" \
  --arch base --subset 3000000 \
  --batch_size_per_device 144 \
  --learning_rate 8e-5 --ema 0.9996 \
  --warmup_steps 19900 --max_steps 398000 \
  --anchor_len 10.0 --mask_type block --mask_ratio 0.65 --mask_len 5 \
  --aug_tea false --aug_stu true
