"""A VQ kernel's share of its roofline (``b1_roofline``; B2's would call it
with ``stats=True``): the least time of one call (``flops.vq_least_seconds``) over the
device time of its kernels in the trace divided by its calls in the
window."""

from benchmark import flops


def share(trace, key: str, names: tuple, exclude: tuple, stats: bool):
    calls = trace.counters.get(key, 0)
    seconds = trace.kernel_seconds(*names, exclude=exclude)
    if not calls or seconds <= 0 or key not in trace.shapes:
        return None
    m, n, d = trace.shapes[key]
    return 100.0 * flops.vq_least_seconds(m, n, d, stats)["seconds"] / (seconds / calls)
