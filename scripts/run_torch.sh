#!/bin/bash
# Canonical VOC 15-5 three-stage recipe through the PyTorch port's CLI: the
# stages, flags, epochs, learning rates and checkpoint hand-offs of
# scripts/run.sh (parity with reference scripts/run.sh), on the card
# (--device defaults to cuda). Several cards: run each stage under
# torchrun with CL4WSIS_MULTIHOST=1 (README).
set -e
overlap=${1:-1}

dataset=voc
task=15-5  # or 10-10
lr_init=0.00005
ov=""
[ "$overlap" -eq 1 ] && ov="--overlap true" || ov="--overlap false"

pars="--dataset ${dataset} --task ${task} --batch_size 16 $ov --val_interval 10"
run="python -m cl4wsis_tpu_torch.cli.main"

# step 0: fully supervised base
$run --name OURS --step 0 --bce true --lr ${lr_init} ${pars} --epochs 100 \
  --optim adam --weight_decay 0

# phase 1: CL-WSSS
$run --name OURS --step 1 --weakly true --phase 1 ${pars} --alpha 0.5 \
  --lr 0.001 --loss_de 1 --lr_policy warmup --affinity true --epochs 40 \
  --optim sgd

# phase 2: CL4WSIS instance (run.sh sets this path in a command
# substitution that fails under set -e at overlap 0, and stops here)
path=checkpoints/step/${dataset}-${task}
[ "$overlap" -eq 1 ] && path=${path}-ov
$run --name OURS --step 1 --weakly true --phase 2 ${pars} --alpha 0.5 \
  --lr ${lr_init} --loss_de 1 --lr_policy warmup --affinity true --epochs 50 \
  --optim adam --weight_decay 0 --seg_ckpt ${path}/OURS_1
