"""``mfu_pct.kandinsky22_movq``: in the MoVQ decoding cell, the model's
FLOPs per image (``flops.py``, counted on the plain reference) times the
traced window's images per second, over the H100's dense bf16 peak, in %."""

from benchmark.metrics._mfu import mfu


def read(trace):
    return mfu(trace, "detokenize")
