"""Device ms a step of the label factory (the stage span
``phase2.label_factory``: the factory and the blend of its targets)."""

from benchmark.harness.spans import device_ms


def read(ctx):
    return device_ms(ctx, ("phase2.label_factory",), "steps")
