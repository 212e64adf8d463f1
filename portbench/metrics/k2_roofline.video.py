"""k2_roofline.video: K2's share of its roofline, over the kernels that the
``depth_pro::resblock`` operator's calls launched in the profiled slice."""

from portbench.metrics._slice import roofline


def read(ctx):
    return roofline(ctx, "depth_pro::resblock")
