"""``decode_host_ms``: the mean per request of the window of the host ms of
the span ``api.reconstruct_from_tokens``: the time the host takes to
enqueue a request's work (the call does not wait for the card)."""

from benchmark.metrics._spans import mean, window_calls


def read(trace):
    calls = window_calls(trace, "detokenize", "api.reconstruct_from_tokens")
    if calls is None:
        return None
    return mean(c.top["host_ms"] for c in calls)
