"""Device ms an image of the validation post-processing (the stage span
``eval.postproc``: resizes, softmax, the pad mask and ``get_ins_map``)."""

from benchmark.harness.spans import device_ms


def read(ctx):
    return device_ms(ctx, ("eval.postproc",), "images")
