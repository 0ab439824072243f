"""cl4wsis_tpu_torch: the PyTorch/CUDA port of cl4wsis_tpu for NVIDIA Hopper.

The layout mirrors the JAX package so each counterpart is easy to find:
  core/    ABN (eval and train mode), the norm factory, --remat and the
           data-parallel runs over several processes (dist.py)
  models/  ResNet and WideResNet backbones, DeepLab-v3 head,
           Panoptic-DeepLab decoder/head, test-time augmentation
  wss/     PseudoLabeler, PeakGenerator and the weak-supervision losses
  ops/     instance post-processing, the phase-2 label factory, the step-0
           targets and PAMR, with hand-written CUDA kernels (csrc/*.cu) for
           top-k, connected components (multilabel and binary), run totals
           and the gaussian stamp, each beside its plain PyTorch version
  train/   the bucketed eval forward and validation, the step-0, phase-1
           and phase-2 train steps, losses, schedules, the grouped
           optimizer and the Trainer
  metrics/ semantic confusion-matrix metrics and instance AP
  data/    the VOC, COCO and COCO-to-VOC datasets, transforms (numpy and
           Pillow), COCO masks and RLE through a host C++ library
           (csrc/maskops.cpp, built with g++), the worker-process loader,
           and synthetic batches
  cl/      the CL task registry, checkpoints, classifier expansion, the
           iABN ingest and the weight carry-over from the JAX package
  cli/     the configuration and ``python -m cl4wsis_tpu_torch.cli.main``
  utils/   the logger (scalars, images, figures), the step timer, the
           colour maps and sample images, and a reader of the profiler's
           Chrome traces (device busy time, per-step device time, kernels)
  serve.py the Predictor (from a checkpoint, with flip, COCO export)

The ported paths are serving, the three train steps (step 0, phase 1,
phase 2) and the CLI chain over them, through every incremental step of
the multi-step protocols (VOC 15-1, 10-5, ...), on VOC, COCO,
COCO-to-VOC or synthetic data, on one card or data-parallel over several,
with checkpoints, validation and its sample images.
The package never imports JAX or the JAX package.
"""

__version__ = "0.5.0"
