"""``decoder_ms.kandinsky22_movq``: ``decoder_ms`` read in the MoVQ decoding
cell (the mean per request of the device ms of the span ``decoder`` under
``api.reconstruct_from_tokens``)."""

from benchmark.metrics.decoder_ms import read  # noqa: F401
