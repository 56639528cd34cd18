"""Shared by the readers of the port's spans: the traced window's calls
(train steps or API requests), each with the spans under it, from the
port's in-memory span log (``vqvae_tpu_torch.utils.introspect.span_log``),
and sums of their device ms.

Nothing where the program keeps no span log, or where the log does not
belong to the traced window: in a training window the ``train.step`` spans
and their ``r1`` flags must be the window's steps (``trace.step_ms``'s
labels, in order); in an API window the ``api.*`` spans' ``images`` must
sum to the window's images."""


def _log():
    try:
        from vqvae_tpu_torch.utils import introspect
    except ImportError:
        return None
    read = getattr(introspect, "span_log", None)
    return read() if read is not None else None


class Call:
    """One top-level span and every span that shares its id."""

    def __init__(self, top: dict, spans: list, by_index: dict):
        self.top, self.spans, self._by_index = top, spans, by_index

    def _under(self, span: dict, name: str) -> bool:
        parent = span["parent"]
        while parent is not None:
            up = self._by_index[parent]
            if up["name"] == name:
                return True
            parent = up["parent"]
        return False

    def ms(self, names, within=None) -> float:
        """The summed device ms of the spans named in ``names`` (under a span
        named ``within``, if given)."""
        return sum(s["device_ms"] for s in self.spans
                   if s["name"] in names and (within is None or self._under(s, within)))


def window_calls(trace, kind: str, top: str):
    """-> the window's calls whose top-level span is named ``top``, or None
    (module docstring)."""
    if trace.kind != kind:
        return None
    spans = _log()
    if not spans or any(s["device_ms"] is None for s in spans):
        return None
    tops = [s for s in spans if s["parent"] is None]
    if kind == "train":
        steps = [s for s in tops if s["name"] == "train.step"]
        if ["r1" if s["attrs"].get("r1") else "plain" for s in steps] != \
                [label for label, _ in trace.step_ms]:
            return None
    else:
        api = [s for s in tops if s["name"].startswith("api.")]
        if sum(s["attrs"].get("images", 0) for s in api) != trace.images:
            return None
    by_index = {s["index"]: s for s in spans}
    by_id = {}
    for s in spans:
        by_id.setdefault(s["id"], []).append(s)
    return [Call(t, by_id[t["id"]], by_index) for t in tops if t["name"] == top]


def mean(values):
    values = list(values)
    return sum(values) / len(values) if values else None
