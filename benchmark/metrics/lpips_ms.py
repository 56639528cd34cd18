"""``lpips_ms``: the mean per step of the window of the device ms of the span
``lpips`` (LPIPS's forward; its backward runs in ``ae.backward``).
Nothing where no step ran LPIPS."""

from benchmark.metrics._spans import mean, window_calls


def read(trace):
    calls = window_calls(trace, "train", "train.step")
    values = [c.ms(("lpips",)) for c in calls or ()]
    return mean(values) if any(values) else None
