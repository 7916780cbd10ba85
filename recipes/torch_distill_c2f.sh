#!/bin/bash
# distill_c2f.sh on the PyTorch port (audiossl_tpu_torch), flag for flag; the
# CLI runs on the card by default. The recipe it follows:
# ATST-C2F distillation on AudioSet-2M (reference train_distill.py:
# frozen finetuned clip teacher -> FrameAST student, layer decay 0.75,
# class-balanced sampling).
TEACHER=${1:?usage: torch_distill_c2f.sh TEACHER_CKPT STUDENT_CKPT DATA_DIR}
STUDENT=${2:?}
DATA=${3:?}
python -m audiossl_tpu_torch.methods.distill.train \
  --teacher_ckpt_path "$TEACHER" --student_ckpt_path "$STUDENT" \
  --data_path "$DATA" --balanced_sampling --layer_wise_lr 0.75
