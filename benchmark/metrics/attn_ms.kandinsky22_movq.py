"""``attn_ms.kandinsky22_movq``: ``attn_ms`` read in the MoVQ decoding cell
(the mean per request of the device ms of the spans ``attn`` inside
``decoder`` under ``api.reconstruct_from_tokens``; each holds its block's
``spatial_norm``)."""

from benchmark.metrics.attn_ms import read  # noqa: F401
