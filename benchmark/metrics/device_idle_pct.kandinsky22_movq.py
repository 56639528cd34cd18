"""``device_idle_pct.kandinsky22_movq``: in the MoVQ decoding cell, the
share of the traced window in which no kernel, memcpy or memset ran on the
card, in %."""

from benchmark.metrics._idle import idle


def read(trace):
    return idle(trace, "detokenize")
