"""Device ms an image of the validation forward (the stage span
``eval.forward``: the input's transfer and layout and the model)."""

from benchmark.harness.spans import device_ms


def read(ctx):
    return device_ms(ctx, ("eval.forward",), "images")
