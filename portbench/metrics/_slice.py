"""Readings of a profiled slice that several metrics share."""

from __future__ import annotations

from portbench.flops import (attention_bytes, attention_flops, bound_s, frame_flops,
                             resblock_bytes, resblock_flops)


def idle_share(sl) -> float | None:
    """Percent of the slice's window with no kernel, copy or memset on the card."""
    if sl is None or sl.window_s <= 0:
        return None
    return 100.0 * (1.0 - sl.busy_s / sl.window_s)


def ms_per_frame(sl, *groups: str) -> float | None:
    """Device milliseconds per frame of the kernels in ``groups``."""
    if sl is None or not sl.frames:
        return None
    seconds = sl.group_seconds()
    if not any(g in seconds for g in groups):
        return None
    return 1e3 * sum(seconds.get(g, 0.0) for g in groups) / sl.frames


def mfu(ctx) -> float | None:
    """A frame's FLOPs at the slice's frames a second on each card, over the
    card's bf16 peak."""
    sl = ctx.slice
    if sl is None or not sl.frames or sl.window_s <= 0:
        return None
    from portbench.flops import PEAK_BF16_FLOPS

    return 100.0 * frame_flops(ctx.arch) * sl.frames / sl.window_s / PEAK_BF16_FLOPS


def _dims(call):
    return call[1] or []


def roofline(ctx, op: str) -> float | None:
    """Percent of the bound (bytes over 3.35 TB/s or FLOPs over 989 TFLOP/s,
    whichever is larger) over the device time of the kernels that the
    operator ``op``'s calls launched, summed over its calls in the slice."""
    sl = ctx.slice
    if sl is None:
        return None
    bound = spent = 0.0
    heads = ctx.arch.num_heads
    for name, dims, seconds in sl.calls:
        if name != op:
            continue
        dims = _dims((name, dims))
        if op == "depth_pro::resblock":
            b, h, w, c = dims[0]
            bound += bound_s(resblock_flops(b, h, w, c), resblock_bytes(b, h, w, c))
        else:
            b, s, d3 = dims[0]
            d = d3 // 3
            bound += bound_s(attention_flops(b, heads, s, d // heads),
                             attention_bytes(b, s, d, bias=op.endswith("_bias")))
        spent += seconds
    return 100.0 * bound / spent if spent > 0 else None
