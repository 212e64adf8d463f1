"""merge_ms_per_frame.video: device milliseconds per frame of the sort,
scatter and gather kernels (the ToMe merge and unmerge) in the profiled
slice."""

from portbench.metrics._slice import ms_per_frame


def read(ctx):
    return ms_per_frame(ctx.slice, "sort / scatter / gather")
