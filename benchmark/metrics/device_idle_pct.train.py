"""``device_idle_pct.train``: the share of the traced window in which no
kernel, memcpy or memset ran on the card, in %."""

from benchmark.metrics._idle import idle


def read(trace):
    return idle(trace, "train")
