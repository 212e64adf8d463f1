"""conv_ms_per_frame.video: device milliseconds per frame of the cuDNN convolution kernels in the
profiled slice."""

from portbench.metrics._slice import ms_per_frame


def read(ctx):
    return ms_per_frame(ctx.slice, "conv (cuDNN)")
