"""Readings of a profiled slice of Video Depth Anything windows that its
metrics share. A slice's frames are the windows' new frames. Given another
family's shapes they read nothing (None)."""

from __future__ import annotations

from portbench.flops import PEAK_BF16_FLOPS, attention_bytes, attention_flops, bound_s
from portbench.flops_vda import new_frame_flops
from portbench.reference.video_depth_anything import Arch


def mfu(ctx) -> float | None:
    """The work a new frame needs (``flops_vda.new_frame_flops``) at the
    slice's new frames a second, over the card's bf16 peak."""
    sl = ctx.slice
    if sl is None or not sl.frames or sl.window_s <= 0 or not isinstance(ctx.arch, Arch):
        return None
    return 100.0 * new_frame_flops(ctx.arch) * sl.frames / sl.window_s / PEAK_BF16_FLOPS


def attention_roofline(ctx, part: str) -> float | None:
    """Percent of the bound (``portbench/flops.py``: bytes over 3.35 TB/s or
    FLOPs over 989 TFLOP/s, whichever is larger) over the device time of the
    kernels that ``depth_pro::attention_packed``'s calls launched, summed
    over the calls of ``part`` in the slice: ``"vit"``, the calls at the
    ViT's tokens (16 heads); ``"temporal"``, those along the window's frames
    (8 heads)."""
    sl, arch = ctx.slice, ctx.arch
    if sl is None or not isinstance(arch, Arch):
        return None
    seq_len, heads = ((arch.tokens, arch.num_heads) if part == "vit"
                      else (arch.window, arch.temporal_heads))
    bound = spent = 0.0
    for name, dims, seconds in sl.calls:
        if name != "depth_pro::attention_packed" or not dims:
            continue
        b, s, d3 = dims[0]
        if s != seq_len:
            continue
        d = d3 // 3
        bound += bound_s(attention_flops(b, heads, s, d // heads), attention_bytes(b, s, d))
        spent += seconds
    return 100.0 * bound / spent if spent > 0 else None
