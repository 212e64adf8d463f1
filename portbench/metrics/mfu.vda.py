"""mfu.vda: the work a new frame needs (the encoder once, the head and
temporal modules over the window, ``portbench/flops_vda.py``) times the
profiled slice's new frames a second, over the card's bf16 peak."""

from portbench.metrics._vda import mfu


def read(ctx):
    return mfu(ctx)
