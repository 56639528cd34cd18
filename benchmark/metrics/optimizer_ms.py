"""``optimizer_ms``: the mean per step of the window of the device ms of the
span ``optim`` (the gradient reductions and both AdamW steps; the usage
count, which waits for the card, is the span ``usage`` after it)."""

from benchmark.metrics._spans import mean, window_calls


def read(trace):
    calls = window_calls(trace, "train", "train.step")
    if calls is None:
        return None
    return mean(c.ms(("optim",)) for c in calls)
