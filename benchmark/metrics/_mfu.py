"""Shared by the ``mfu_pct.*`` readers."""

from benchmark import flops


def mfu(trace, kind: str):
    if trace.kind != kind or not trace.flops_per_image or trace.window_s <= 0:
        return None
    return 100.0 * trace.flops_per_image * trace.images / trace.window_s / flops.PEAK_BF16_FLOPS
