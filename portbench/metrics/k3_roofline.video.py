"""k3_roofline.video: K3's share of its roofline, over the kernels that the
``depth_pro::attention_packed_bias`` operator's calls launched in the profiled slice."""

from portbench.metrics._slice import roofline


def read(ctx):
    return roofline(ctx, "depth_pro::attention_packed_bias")
