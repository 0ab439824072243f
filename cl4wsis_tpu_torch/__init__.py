"""cl4wsis_tpu_torch: the PyTorch/CUDA port of cl4wsis_tpu for NVIDIA Hopper.

The layout mirrors the JAX package so each counterpart is easy to find:
  core/    eval-mode ABN and the norm factory
  models/  ResNet backbone, DeepLab-v3 head, Panoptic-DeepLab decoder/head
  ops/     instance post-processing, with hand-written CUDA kernels
           (csrc/*.cu) for top-k, multilabel connected components and run
           totals, each beside its plain PyTorch version
  train/   the bucketed eval forward
  cl/      weight carry-over from the JAX package
  serve.py the Predictor

This slice covers the serving path; training, data and checkpoints come
later. The package never imports JAX or the JAX package.
"""

__version__ = "0.1.0"
