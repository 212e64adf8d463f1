"""k1_roofline.video: K1's share of its roofline, over the kernels that the
``depth_pro::attention_packed`` operator's calls launched in the profiled slice."""

from portbench.metrics._slice import roofline


def read(ctx):
    return roofline(ctx, "depth_pro::attention_packed")
