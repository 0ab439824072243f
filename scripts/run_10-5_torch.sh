#!/bin/bash
# Multi-step VOC 10-5 chaining through the PyTorch port's CLI, stage for
# stage scripts/run_10-5.sh (parity with reference scripts/run_10-5.sh):
# base step 0, then two incremental steps, each phase 1 -> phase 2, on the
# card (--device defaults to cuda).
set -e
dataset=voc
task=10-5
lr_init=0.00005
pars="--dataset ${dataset} --task ${task} --batch_size 16 --overlap true --val_interval 10"
run="python -m cl4wsis_tpu_torch.cli.main"
path=checkpoints/step/${dataset}-${task}-ov

$run --name OURS --step 0 --bce true --lr ${lr_init} ${pars} --epochs 100 \
  --optim adam --weight_decay 0

for step in 1 2; do
  $run --name OURS --step ${step} --weakly true --phase 1 ${pars} --alpha 0.5 \
    --lr 0.001 --loss_de 1 --lr_policy warmup --affinity true --epochs 40 --optim sgd
  $run --name OURS --step ${step} --weakly true --phase 2 ${pars} --alpha 0.5 \
    --lr ${lr_init} --loss_de 1 --lr_policy warmup --affinity true --epochs 50 \
    --optim adam --weight_decay 0 --seg_ckpt ${path}/OURS_${step}
done
