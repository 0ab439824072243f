"""The benchmark of the PyTorch/CUDA port (``cl4wsis_tpu_torch``): a
harness driven by the files under ``configs/``, ``traffic/``, ``limits/``
and ``metrics/``, with a plain reference under ``reference/``."""
