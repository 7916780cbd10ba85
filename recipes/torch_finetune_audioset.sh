#!/bin/bash
# finetune_audioset.sh on the PyTorch port (audiossl_tpu_torch), flag for flag; the
# CLI runs on the card by default. The recipe it follows:
# AudioSet finetune (reference: batch_size_per_gpu x nproc = 512,
# layer decay 0.75, mixup, weighted sampler, grad clip 3.0).
CKPT=${1:?usage: torch_finetune_audioset.sh CKPT AUDIOSET_DIR [clip|frame]}
DATA=${2:?}
TYPE=${3:-clip}
python -m audiossl_tpu_torch.downstream.train_finetune \
  --pretrained_ckpt_path "$CKPT" --data_path "$DATA" \
  --dataset_name audioset --model_type "$TYPE" --arch base \
  --batch_size 512 --layer_wise_lr 0.75
