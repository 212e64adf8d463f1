"""mfu.video: the model's FLOPs per frame (counted from the configuration's
shapes) times the profiled slice's frames a second, over the card's bf16 peak."""

from portbench.metrics._slice import mfu


def read(ctx):
    return mfu(ctx)
