"""temporal_roofline.vda: K1's share of its roofline in the temporal
modules, over the kernels that ``depth_pro::attention_packed``'s calls along
the window's 32 frames launched in the profiled slice."""

from portbench.metrics._vda import attention_roofline


def read(ctx):
    return attention_roofline(ctx, "temporal")
