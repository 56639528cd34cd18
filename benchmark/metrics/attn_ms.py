"""``attn_ms``: the mean per request of the window of the device ms of the
spans ``attn`` (each single-head attention block of the taming layout)
inside ``decoder`` under ``api.reconstruct_from_tokens``, summed per
request."""

from benchmark.metrics._spans import mean, window_calls


def read(trace):
    calls = window_calls(trace, "detokenize", "api.reconstruct_from_tokens")
    if calls is None:
        return None
    return mean(c.ms(("attn",), within="decoder") for c in calls)
