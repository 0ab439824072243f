"""Idle ms a step put down to the label factory: the device's gaps ended
by a launch in the stage span ``phase2.label_factory``."""

from benchmark.harness.spans import idle_ms


def read(ctx):
    return idle_ms(ctx, "phase2.label_factory", "steps")
