"""conv_ms_per_frame.vda: device milliseconds per new frame of the cuDNN
convolution kernels in the profiled slice (the DPT head's convs)."""

from portbench.metrics._slice import ms_per_frame


def read(ctx):
    return ms_per_frame(ctx.slice, "conv (cuDNN)")
