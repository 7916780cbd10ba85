#!/bin/bash
# atst_frame_small.sh on the PyTorch port (audiossl_tpu_torch), flag for flag; the
# CLI runs on the card by default. The recipe it follows:
# ATST-Frame SMALL pretraining (reference methods/atstframe/
# train_small.sh: bs 256/GPU x4, lr 4e-4, ema 0.997, 58.5k steps,
# warmup 1,950).
DATA=${1:?usage: torch_atst_frame_small.sh AUDIOSET_ARDS_DIR [SAVE]}
SAVE=${2:-./exp/atstframe_small}
python -m audiossl_tpu_torch.methods.atstframe.train \
  --data_path "$DATA" --save_path "$SAVE" \
  --arch small --subset 3000000 \
  --batch_size_per_device 256 \
  --learning_rate 4e-4 --ema 0.997 \
  --warmup_steps 1950 --max_steps 58500 \
  --anchor_len 10.0 --mask_type block --mask_ratio 0.65 --mask_len 5
