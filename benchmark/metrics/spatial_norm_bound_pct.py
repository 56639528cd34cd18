"""``spatial_norm_bound_pct``: the SpatialNorm calls' share of their byte
roofline, in %: 100 x the sum of their least seconds (``_norm_bytes``, from
the attributes of the window's spans ``spatial_norm`` inside ``decoder``
under ``api.reconstruct_from_tokens``) over the device seconds, in the
profiler's trace of the window, of the kernels that carry their work on f:
the port's GroupNorm kernels (``csrc/gn_silu.cu``, names ``::gn_...``),
PyTorch's ``addcmul`` (the modulation) and ``silu``. In MoVQ's decoding
cell every GroupNorm, addcmul and SiLU of the window belongs to a
SpatialNorm. The 1x1 convs on zq run at the latents' resolution and share
their kernels' names with every other conv: their time is left out. Being
kernel time, it holds no wait for the host. Nothing where the program
opens no such span or the trace holds none of these kernels (a run on the
CPU)."""

from benchmark.metrics._norm_bytes import least_seconds
from benchmark.metrics._spans import window_calls

KERNELS = ("::gn_", "addcmul_cuda_kernel", "silu_kernel")


def read(trace):
    calls = window_calls(trace, "detokenize", "api.reconstruct_from_tokens")
    if calls is None:
        return None
    spans = [s for c in calls for s in c.spans
             if s["name"] == "spatial_norm" and c._under(s, "decoder")]
    device_s = trace.kernel_seconds(*KERNELS)
    if not spans or device_s <= 0:
        return None
    return 100.0 * sum(least_seconds(s["attrs"]) for s in spans) / device_s
