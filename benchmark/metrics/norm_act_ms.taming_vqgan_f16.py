"""``norm_act_ms.taming_vqgan_f16``: ``norm_act_ms`` read in the taming
decoding cell (the mean per request of the device ms of the spans
``norm_act`` inside ``decoder`` under ``api.reconstruct_from_tokens``)."""

from benchmark.metrics.norm_act_ms import read  # noqa: F401
