"""The least bytes and time of one ``spatial_norm`` span (a SpatialNorm
call, with or without its SiLU), from the span's attributes: one read of f
and one write of the result (``elements`` x ``element_bytes`` each) and one
read of the quantized latents zq (``cond_elements`` x ``element_bytes``),
at the card's memory bandwidth. The 1x1 convs' parameters (about 10 KB a
call against tens of MB of f) are left out. It counts the work whatever
implements it: the plain composition reads and writes more, a fused kernel
would come near it."""

from benchmark.flops import PEAK_HBM_BYTES_PER_S


def least_bytes(attrs: dict) -> float:
    return (2.0 * attrs["elements"] + attrs["cond_elements"]) * attrs["element_bytes"]


def least_seconds(attrs: dict) -> float:
    return least_bytes(attrs) / PEAK_HBM_BYTES_PER_S
