"""idle_share.video: percent of the profiled window with nothing running on the card."""

from portbench.metrics._slice import idle_share


def read(ctx):
    return idle_share(ctx.slice)
