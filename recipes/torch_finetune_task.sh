#!/bin/bash
# finetune_task.sh on the PyTorch port (audiossl_tpu_torch), flag for flag; the
# CLI runs on the card by default. The recipe it follows:
# Per-dataset finetune recipes transcribed from the reference shell
# wrappers (audiossl/methods/{atst,atstframe}/shell/downtream/finetune/
# eval_*.sh): global batch 512 (batch_size_per_gpu x nproc = 512,
# atst/README.md:67), n_last_blocks 1, layer-wise decay 0.75, and the
# per-dataset lr / epochs / mixup / rrc / alpha settings below. The
# first lr of each reference sweep is the default; pass LR to override.
#
# usage: torch_finetune_task.sh DATASET {clip|frame} CKPT DATA_DIR [LR]
# (the usage message escapes its "}": unescaped, it ends the ${1:?...}
# expansion, and bash runs "CKPT" as a command)
set -e
DS=${1:?usage: torch_finetune_task.sh DATASET {clip|frame\} CKPT DATA_DIR [LR]}
TYPE=${2:?clip|frame}
CKPT=${3:?}
DATA=${4:?}
LR_OVERRIDE=${5:-}

COMMON=(--pretrained_ckpt_path "$CKPT" --data_path "$DATA"
        --dataset_name "$DS" --model_type "$TYPE" --arch base
        --batch_size 512 --n_last_blocks 1 --layer_wise_lr 0.75 --rrc)

case "$DS:$TYPE" in
  # reference atst/shell/downtream/finetune/eval_<ds>.sh
  audioset:clip)   ARGS=(--learning_rate 5e-1 --max_epochs 10  --warmup_epochs 2 --alpha 0.5);;
  audioset_b:clip) ARGS=(--learning_rate 1.0  --max_epochs 200 --warmup_epochs 5 --alpha 0.5);;
  fsd50k:clip)     ARGS=(--learning_rate 5e-1 --max_epochs 100 --warmup_epochs 5 --alpha 0.5);;
  nsynth:clip)     ARGS=(--learning_rate 5e-4 --max_epochs 50  --warmup_epochs 5 --alpha 0.5);;
  spcv2:clip)      ARGS=(--learning_rate 5e-1 --max_epochs 50  --warmup_epochs 5 --alpha 0.5);;
  us8k:clip)       ARGS=(--learning_rate 2e-3 --max_epochs 50  --warmup_epochs 5 --alpha 0.5);;
  voxceleb1:clip)  ARGS=(--learning_rate 1e-1 --max_epochs 50  --warmup_epochs 5 --alpha 0.5 --no-mixup);;
  # reference atstframe/shell/downtream/finetune/eval_<ds>.sh
  # (mixup_ratio 0.5 throughout; alpha per dataset; use_encoder teacher)
  audioset:frame)   ARGS=(--learning_rate 5e-1 --max_epochs 11  --warmup_epochs 2 --mixup_ratio 0.5 --alpha 10);;
  audioset_b:frame) ARGS=(--learning_rate 1.0  --max_epochs 200 --warmup_epochs 5 --mixup_ratio 0.5 --alpha 0.5);;
  fsd50k:frame)     ARGS=(--learning_rate 5e-1 --max_epochs 100 --warmup_epochs 5 --mixup_ratio 0.5 --alpha 10);;
  nsynth:frame)     ARGS=(--learning_rate 5e-4 --max_epochs 50  --warmup_epochs 5 --mixup_ratio 0.5 --alpha 0.5 --no-mixup);;
  spcv2:frame)      ARGS=(--learning_rate 1.0  --max_epochs 50  --warmup_epochs 5 --mixup_ratio 0.5 --alpha 10);;
  us8k:frame)       ARGS=(--learning_rate 2e-3 --max_epochs 50  --warmup_epochs 5 --mixup_ratio 0.5 --alpha 0.5);;
  voxceleb1:frame)  ARGS=(--learning_rate 1e-1 --max_epochs 50  --warmup_epochs 5 --mixup_ratio 0.5 --alpha 10 --no-mixup);;
  *) echo "unknown dataset/type: $DS:$TYPE" >&2; exit 2;;
esac

if [ -n "$LR_OVERRIDE" ]; then
  FILTERED=()
  skip=0
  for a in "${ARGS[@]}"; do
    if [ $skip -eq 1 ]; then skip=0; continue; fi
    if [ "$a" = "--learning_rate" ]; then skip=1; continue; fi
    FILTERED+=("$a")
  done
  ARGS=(--learning_rate "$LR_OVERRIDE" "${FILTERED[@]}")
fi

python -m audiossl_tpu_torch.downstream.train_finetune "${COMMON[@]}" "${ARGS[@]}"
