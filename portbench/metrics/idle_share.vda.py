"""idle_share.vda: percent of the profiled windows with nothing running on the card."""

from portbench.metrics._slice import idle_share


def read(ctx):
    return idle_share(ctx.slice)
