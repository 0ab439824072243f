"""Device ms a step of the phase-2 step's frozen networks (the stage span
``phase2.frozen``: the input's layout, the old model, both seg passes and
the CAM)."""

from benchmark.harness.spans import device_ms


def read(ctx):
    return device_ms(ctx, ("phase2.frozen",), "steps")
