#!/bin/bash
# COCO-to-VOC recipe through the PyTorch port's CLI, stage for stage
# scripts/coco.sh (parity with reference scripts/coco.sh): WideResNet-38,
# OS8, crop 448, step-0 200 epochs; phase-1 alpha 0.9; on the card
# (--device defaults to cuda).
set -e
pars="--dataset coco-voc --task voc --batch_size 16 --val_interval 2"
run="python -m cl4wsis_tpu_torch.cli.main"
path=checkpoints/step/coco-voc-voc

$run --name OURS --step 0 --bce true --lr 0.00005 ${pars} --epochs 200 \
  --optim adam --weight_decay 0

$run --name OURS --step 1 --weakly true --phase 1 ${pars} --alpha 0.9 \
  --lr 0.001 --loss_de 1 --lr_policy warmup --affinity true --epochs 30 --optim sgd

$run --name OURS --step 1 --weakly true --phase 2 ${pars} --alpha 0.9 \
  --lr 0.00005 --loss_de 1 --lr_policy warmup --affinity true --epochs 50 \
  --optim adam --weight_decay 0 --seg_ckpt ${path}/OURS_1
