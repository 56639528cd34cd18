"""``d_ms``: the mean over the window's steps without R1 of the device ms of
the discriminator's first-order work: the spans ``gan.d_real``,
``gan.d_real_backward``, ``gan.d_fake`` and ``gan.d_fake_backward``, summed
per step."""

from benchmark.metrics._spans import mean, window_calls

PHASES = ("gan.d_real", "gan.d_real_backward", "gan.d_fake", "gan.d_fake_backward")


def read(trace):
    calls = window_calls(trace, "train", "train.step")
    if calls is None:
        return None
    return mean(c.ms(PHASES) for c in calls if not c.top["attrs"].get("r1"))
