"""Device ms a step of the phase-2 step's targets (the stage span
``phase2.targets``: CAM peaks, the seg's softmax and argmax, the old
classes' masks and centers)."""

from benchmark.harness.spans import device_ms


def read(ctx):
    return device_ms(ctx, ("phase2.targets",), "steps")
