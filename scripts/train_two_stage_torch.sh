#!/bin/bash
# Two-stage training recipe (the reference train.sh protocol) through the
# PyTorch port on the card, towers on the fused training kernels:
#   stage 1 — descriptor-only (no attention, no orientation regression),
#             rotation-free augmentations, 2 epochs;
#   stage 2 — full model, restore stage-1 weights EXCLUDING the detection
#             scope (its Adam moments restart from zero at stage 1's count),
#             add full-circle Rotate1D, ~70 epochs (saturates ~60).
set -e

DATA_DIR=${1:-data/oxford}

python -m feat3dnet_tpu_torch.cli.train \
    --data_dir "$DATA_DIR" \
    --log_dir ./ckpt_stage1 \
    --augmentation Jitter RotateSmall Shift \
    --noattention --noregress \
    --num_epochs 2 \
    --fused_towers

python -m feat3dnet_tpu_torch.cli.train \
    --data_dir "$DATA_DIR" \
    --log_dir ./ckpt \
    --augmentation Jitter RotateSmall Shift Rotate1D \
    --checkpoint ./ckpt_stage1 \
    --restore_exclude detection \
    --num_epochs 70 \
    --fused_towers
