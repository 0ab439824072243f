"""Idle ms an image put down to the validation post-processing: the
device's gaps ended by a launch in the stage span ``eval.postproc``."""

from benchmark.harness.spans import idle_ms


def read(ctx):
    return idle_ms(ctx, "eval.postproc", "images")
