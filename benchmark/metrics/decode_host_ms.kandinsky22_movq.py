"""``decode_host_ms.kandinsky22_movq``: ``decode_host_ms`` read in the MoVQ
decoding cell (the mean per request of the host ms of the span
``api.reconstruct_from_tokens``: the time the host takes to enqueue a
request's work)."""

from benchmark.metrics.decode_host_ms import read  # noqa: F401
