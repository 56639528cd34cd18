"""``encoder_ms``: the mean per request of the window of the device ms of the
span ``encoder`` under ``api.get_tokens``."""

from benchmark.metrics._spans import mean, window_calls


def read(trace):
    calls = window_calls(trace, "tokenize", "api.get_tokens")
    if calls is None:
        return None
    return mean(c.ms(("encoder",)) for c in calls)
