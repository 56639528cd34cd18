"""``r1_backward_ms``: the mean over the window's R1 steps of the device ms
of the spans ``gan.r1_grad`` (``autograd.grad`` with ``create_graph`` and
the penalty) and ``gan.d_real_backward`` (the backward of the real half
plus the penalty: the second-order pass), summed per step."""

from benchmark.metrics._spans import mean, window_calls


def read(trace):
    calls = window_calls(trace, "train", "train.step")
    if calls is None:
        return None
    return mean(c.ms(("gan.r1_grad", "gan.d_real_backward")) for c in calls
                if c.top["attrs"].get("r1"))
