"""cl4wsis_tpu_torch: the PyTorch/CUDA port of cl4wsis_tpu for NVIDIA Hopper.

The layout mirrors the JAX package so each counterpart is easy to find:
  core/    ABN (eval and train mode) and the norm factory
  models/  ResNet backbone, DeepLab-v3 head, Panoptic-DeepLab decoder/head
  wss/     PseudoLabeler, PeakGenerator and the weak-supervision losses
  ops/     instance post-processing, the phase-2 label factory, the step-0
           targets and PAMR, with hand-written CUDA kernels (csrc/*.cu) for
           top-k, connected components (multilabel and binary), run totals
           and the gaussian stamp, each beside its plain PyTorch version
  train/   the bucketed eval forward and validation, the step-0, phase-1
           and phase-2 train steps, losses, schedules, the grouped
           optimizer and the Trainer
  metrics/ semantic confusion-matrix metrics and instance AP
  data/    synthetic batches
  cl/      the CL task registry, checkpoints, classifier expansion, the
           iABN ingest and the weight carry-over from the JAX package
  cli/     the configuration and ``python -m cl4wsis_tpu_torch.cli.main``
  utils/   the logger and the step timer
  serve.py the Predictor

The ported paths are serving, the three train steps (step 0, phase 1,
phase 2) and the CLI chain over them on synthetic data, with checkpoints
and validation; the real datasets and multi-GPU runs are not ported yet.
The package never imports JAX or the JAX package.
"""

__version__ = "0.4.0"
