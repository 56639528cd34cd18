"""``spatial_norm_ms``: the mean per request of the window of the device ms
of the spans ``spatial_norm`` (each SpatialNorm call of MoVQ's decoder, with
its SiLU where the block takes one; the attention blocks' too, inside
``attn``) inside ``decoder`` under ``api.reconstruct_from_tokens``, summed
per request. Nothing where the program opens no such span."""

from benchmark.metrics._spans import mean, window_calls


def read(trace):
    calls = window_calls(trace, "detokenize", "api.reconstruct_from_tokens")
    if not calls or not any(s["name"] == "spatial_norm" for c in calls for s in c.spans):
        return None
    return mean(c.ms(("spatial_norm",), within="decoder") for c in calls)
