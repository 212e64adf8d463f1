"""k1_roofline.vda: K1's share of its roofline in the ViT, over the kernels
that ``depth_pro::attention_packed``'s calls at the ViT's tokens (2,443 at
1080x1920) launched in the profiled slice."""

from portbench.metrics._vda import attention_roofline


def read(ctx):
    return attention_roofline(ctx, "vit")
