"""Device ms a step of the trained instance branch (the stage spans
``phase2.instance_forward`` and ``phase2.instance_update``: its forward,
losses, backward and Adam)."""

from benchmark.harness.spans import device_ms


def read(ctx):
    return device_ms(ctx, ("phase2.instance_forward",
                           "phase2.instance_update"), "steps")
