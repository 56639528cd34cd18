"""``b1_roofline``: kernel B1's (``csrc/nearest_codes.cu``: its scan, merge,
rescoring and pick kernels) share of its roofline, in %."""

from benchmark.metrics._vq_roofline import share


def read(trace):
    return share(trace, "b1", ("nearest_codes_",), ("nearest_codes_stats",), stats=False)
