"""``gan_step_ms``: the mean time of the window's steps without the R1
penalty, in a run whose window holds R1 steps (the other steps of each R1
cycle), each timed by CUDA events around ``Trainer.train_step``."""


def read(trace):
    if not any(label == "r1" for label, _ in trace.step_ms):
        return None
    times = [ms for label, ms in trace.step_ms if label == "plain"]
    return sum(times) / len(times) if times else None
