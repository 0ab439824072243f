"""cl4wsis_tpu_torch: the PyTorch/CUDA port of cl4wsis_tpu for NVIDIA Hopper.

The layout mirrors the JAX package so each counterpart is easy to find:
  core/    ABN (eval and train mode) and the norm factory
  models/  ResNet backbone, DeepLab-v3 head, Panoptic-DeepLab decoder/head
  wss/     PseudoLabeler, PeakGenerator
  ops/     instance post-processing and the phase-2 label factory, with
           hand-written CUDA kernels (csrc/*.cu) for top-k, connected
           components (multilabel and binary), run totals and the gaussian
           stamp, each beside its plain PyTorch version
  train/   the bucketed eval forward, the phase-2 train step, losses,
           schedules and the grouped optimizer
  data/    synthetic batches
  cl/      weight carry-over from the JAX package
  serve.py the Predictor

The ported paths are serving and the phase-2 train step; step 0, phase 1,
eval metrics, data and checkpoints are not ported yet. The package never
imports JAX or the JAX package.
"""

__version__ = "0.2.0"
