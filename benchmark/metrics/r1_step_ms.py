"""``r1_step_ms``: the mean time of the window's R1 steps, each timed by CUDA
events the benchmark records around ``Trainer.train_step``. Nothing where
the window has no R1 step."""


def read(trace):
    times = [ms for label, ms in trace.step_ms if label == "r1"]
    return sum(times) / len(times) if times else None
