#!/bin/bash
# atst_clip_base.sh on the PyTorch port (audiossl_tpu_torch), flag for flag; the
# CLI runs on the card by default. The recipe it follows:
# ATST-Clip BASE pretraining (reference methods/atst/train_base.sh:
# bs 256/GPU x6, lr 2e-4, ema 0.9995, 318k steps, warmup 15,860,
# subset 3M).
DATA=${1:?usage: torch_atst_clip_base.sh AUDIOSET_ARDS_DIR [SAVE]}
SAVE=${2:-./exp/atst_base}
python -m audiossl_tpu_torch.methods.atst.train \
  --data_path "$DATA" --save_path "$SAVE" \
  --arch base --subset 3000000 \
  --batch_size_per_device 256 \
  --learning_rate 2e-4 --ema 0.9995 \
  --warmup_steps 15860 --max_steps 318000
