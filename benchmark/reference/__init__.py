"""The benchmark's plain reference: frozen copies of the port's arithmetic
with every hand-written kernel replaced by its plain PyTorch version, built
and run in float32 with TF32 off. It imports torch and numpy only, never
``cl4wsis_tpu_torch``, ``cl4wsis_tpu`` or JAX."""
