"""cl4wsis_tpu_torch: the PyTorch/CUDA port of cl4wsis_tpu for NVIDIA Hopper.

The layout mirrors the JAX package so each counterpart is easy to find:
  core/    ABN (eval and train mode) and the norm factory
  models/  ResNet backbone, DeepLab-v3 head, Panoptic-DeepLab decoder/head
  wss/     PseudoLabeler, PeakGenerator and the weak-supervision losses
  ops/     instance post-processing, the phase-2 label factory, the step-0
           targets and PAMR, with hand-written CUDA kernels (csrc/*.cu) for
           top-k, connected components (multilabel and binary), run totals
           and the gaussian stamp, each beside its plain PyTorch version
  train/   the bucketed eval forward, the step-0, phase-1 and phase-2 train
           steps, losses, schedules and the grouped optimizer
  data/    synthetic batches
  cl/      weight carry-over from the JAX package
  serve.py the Predictor

The ported paths are serving and the three train steps (step 0, phase 1,
phase 2); eval metrics, the CL protocol, data and checkpoints are not
ported yet. The package never imports JAX or the JAX package.
"""

__version__ = "0.3.0"
