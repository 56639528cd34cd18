"""Shared by the ``device_idle_pct.*`` readers."""


def idle(trace, kind: str):
    if trace.kind != kind or trace.window_s <= 0 or trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
