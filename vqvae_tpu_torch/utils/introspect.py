"""Introspection (counterpart of ``vqvae_tpu/utils/introspect.py``):

- ``param_summary``: the parameter and byte table per top-level submodule,
  in the JAX package's layout (the reference's ``print_module_summary``);
- ``check_replication``: every parameter and buffer bitwise equal to rank
  0's copy (the reference's ``check_ddp_consistency``), run after init and
  after every restore;
- ``named_scope``, ``span_log`` and ``trace``: the port's spans (the
  reference's ``profiled_function`` scopes), below.

Spans. ``named_scope(name, **attrs)``, as a context manager or a
decorator, marks a span of the program. While no ``torch.profiler``
capture runs it costs one check of ``torch.autograd._profiler_enabled()``
and records nothing: no log entry, no CUDA event, no autograd node. While
one runs (``trace``, the benchmark's ``--trace 1`` window, or any
``torch.profiler.profile``), it opens a record function of the same name,
so the span sits in the capture's timeline on the profiler's clock beside
the kernels it launched, and appends an entry to the span log:
its name and ``attrs``, the index of the span that caused it (``parent``;
stacks are per thread, and a span opened on a thread with no open span,
autograd's worker for one, hangs under the innermost span of the thread
that opened the running top-level span), the ``id`` of its top-level span
(one per train step or API call, shared by every span under it), its host
interval (``time.perf_counter_ns``) and its device interval: a pair of
CUDA events on the stream current when its top-level span opened, resolved
only when read (the host interval on the CPU, whose work is synchronous).
The events come from a pool that every capture reuses; a capture's start
creates at least ``WARM_EVENTS`` of them (and as many as the largest
capture before it took), so that no span of a capture pays for creating
one; a closed span's entry is a tuple of plain values, which the cyclic GC
stops tracking, so that a long capture's log adds no work to the GC's
collections (whose pauses would land in the traced window). The log holds the newest capture's spans: it starts afresh at the
first span of a new capture (``torch.autograd.profiler._run_on_profiler_start``,
which every capture calls before it enables the profiler, is wrapped to
count captures and fill the pool), keeps at most ``MAX_SPANS`` and counts
the ones it drops (``spans_dropped``). ``span_log()`` returns the
resolved entries; ``trace(log_dir)`` writes them as JSON beside its
Chrome trace. ``vqvae_tpu_torch.profile_tokenizer`` sums captures by
kernel kind and by span.

The record function is the profiler's function scope
(``torch._C._profiler._RecordFunctionFast``, a host event in the trace),
not ``torch.profiler.record_function``'s user scope: for a user-scope
range the profiler also puts a ``gpu_user_annotation`` interval on the
card's timeline, from its first kernel to its last, and a reduction that
takes every device event for device work (``benchmark/trace.py``) would
count the span's idle gaps as busy.
"""

from __future__ import annotations

import contextlib
import functools
import json
import os
import threading
import time
from pathlib import Path
from typing import Iterator, Mapping, Tuple, Union

import torch
import torch.distributed as dist
from torch import nn
from torch._C._profiler import _RecordFunctionFast

from vqvae_tpu_torch.parallel.dist import reduce_device, world

Tree = Union[nn.Module, torch.Tensor, Mapping, None]

MAX_SPANS = 100_000
WARM_EVENTS = 16_384   # 8192 spans: a traced benchmark window takes at most ~5000


class _Span:
    """An open span. At its close its entry in the log becomes a tuple of
    plain values (``SpanLog.ROW``, then each attr's key and value), which the
    cyclic GC stops tracking at its first pass, so that a capture's spans
    leave no work to its collections (a tuple that holds a dict or another
    tuple the GC has not passed stays tracked)."""
    __slots__ = ("name", "attrs", "capture", "parent", "id", "index", "t0", "stream", "device",
                 "event", "record")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs = name, attrs
        self.device = self.event = None

    def __enter__(self):
        _LOG.open(self)
        return self

    def __exit__(self, *exc):
        _LOG.close(self)
        return False

    def row(self, t1=None) -> tuple:
        row = (self.name, self.parent, self.id, self.t0, t1, self.device, self.event)
        for item in self.attrs.items():
            row += item
        return row


class SpanLog:
    """The spans of the newest capture, in memory (one per process, as the
    profiler is)."""
    ROW = ("name", "parent", "id", "t0", "t1", "device", "event")

    def __init__(self, limit: int = MAX_SPANS):
        self.limit = limit
        self.captures = 0      # captures started in this process
        self.capture = None    # the capture the entries belong to
        self.entries: list = []  # an open span's ``_Span``, a closed one's row
        self.dropped = 0
        self._next_id = 0
        self._root: list = []  # the stack of the thread that opened the running top-level span
        self._events: dict = {}  # device index -> CUDA events, reused by every capture
        self._taken = 0          # events the current capture has taken from its device's pool
        self._most = 0           # the most that any capture took
        self._lock = threading.Lock()
        self._local = threading.local()

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def open(self, span: _Span) -> None:
        stack = self._stack()
        with self._lock:
            if self.capture != self.captures:
                self.capture, self.entries, self.dropped, self._next_id = self.captures, [], 0, 0
                self._taken = 0
            span.capture = self.capture
            parent = stack[-1] if stack else (self._root[-1] if self._root else None)
            if parent is None or parent.capture != self.capture:   # opened in an older capture
                span.id, self._next_id, self._root = self._next_id, self._next_id + 1, stack
                span.parent, span.stream = None, None
            else:
                span.id, span.parent, span.stream = parent.id, parent.index, parent.stream
            if len(self.entries) < self.limit:
                span.index = len(self.entries)
                self.entries.append(span)
                if torch.cuda.is_initialized():
                    if span.stream is None:
                        span.stream = torch.cuda.current_stream()
                    span.device = span.stream.device_index
                    span.event = self._take(span.device)
            else:
                span.index = None
                self.dropped += 1
            stack.append(span)
        span.record = _RecordFunctionFast(span.name)
        span.record.__enter__()
        if span.event is not None:
            self._events[span.device][span.event].record(span.stream)
        span.t0 = time.perf_counter_ns()

    def _take(self, device: int) -> int:
        """-> i: events i and i + 1 of ``device``'s pool, which no other span
        of this capture holds."""
        pool = self._events.setdefault(device, [])
        i = self._taken
        self._taken = i + 2
        self._most = max(self._most, self._taken)
        while len(pool) < self._taken:
            pool.append(torch.cuda.Event(enable_timing=True))
        return i

    def warm(self) -> None:
        """Create the current device's pool up to what a capture may take
        (a pooled event is created on the card at its first record)."""
        if not torch.cuda.is_initialized():
            return
        device = torch.cuda.current_device()
        pool = self._events.setdefault(device, [])
        stream = torch.cuda.current_stream()
        while len(pool) < max(WARM_EVENTS, self._most):
            event = torch.cuda.Event(enable_timing=True)
            event.record(stream)
            pool.append(event)

    def close(self, span: _Span) -> None:
        t1 = time.perf_counter_ns()
        mine = span.capture == self.capture   # else a newer capture holds its events and slot
        if span.event is not None and mine:
            self._events[span.device][span.event + 1].record(span.stream)
        span.record.__exit__(None, None, None)
        stack = self._stack()
        with self._lock:
            if stack and stack[-1] is span:
                stack.pop()
            else:
                stack.remove(span)
            if mine and span.index is not None:
                self.entries[span.index] = span.row(t1)

    def resolve(self) -> list:
        """-> one dict per entry, times in ms: ``host_ms`` and ``device_ms``
        (None while the span is open), ``device_start_ms`` from the log's
        first span's start."""
        rows = [e.row() if isinstance(e, _Span) else e for e in list(self.entries)]
        if any(r[6] is not None for r in rows):
            torch.cuda.synchronize()
        origin = None   # the first span's start event
        if rows and rows[0][6] is not None:
            origin = self._events[rows[0][5]][rows[0][6]]
        out = []
        for index, row in enumerate(rows):
            name, parent, id_, t0, t1, device, event = row[:7]
            closed = t1 is not None
            if event is not None:
                pool = self._events[device]
                start = (pool[event] if origin is None else origin).elapsed_time(pool[event])
                span_ms = pool[event].elapsed_time(pool[event + 1]) if closed else None
            else:
                start = (t0 - rows[0][3]) / 1e6
                span_ms = (t1 - t0) / 1e6 if closed else None
            out.append({"index": index, "name": name, "attrs": dict(zip(row[7::2], row[8::2])),
                        "parent": parent, "id": id_, "host_start_ns": t0, "host_end_ns": t1,
                        "host_ms": (t1 - t0) / 1e6 if closed else None,
                        "device_start_ms": start, "device_ms": span_ms})
        return out


_LOG = SpanLog()


def _count_captures(start):
    @functools.wraps(start)
    def wrapper(*args, **kwargs):
        _LOG.captures += 1
        _LOG.warm()
        return start(*args, **kwargs)
    wrapper.counts_captures = True
    return wrapper


if not getattr(torch.autograd.profiler._run_on_profiler_start, "counts_captures", False):
    torch.autograd.profiler._run_on_profiler_start = _count_captures(
        torch.autograd.profiler._run_on_profiler_start)


class _Off:
    """What ``named_scope`` returns while no capture runs."""
    __slots__ = ("name", "attrs")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs = name, attrs

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def __call__(self, fn):
        name, attrs = self.name, self.attrs

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            with named_scope(name, **attrs):
                return fn(*args, **kwargs)
        return wrapper


_OFF: dict = {}


def named_scope(name: str, **attrs):
    """A span of the program named ``name`` (module docstring), as ``with
    named_scope(name, **attrs):`` or ``@named_scope(name)``. A top-level
    span carries ``images``, the batch it takes."""
    if torch.autograd._profiler_enabled():
        return _Span(name, attrs)
    if attrs:
        return _Off(name, attrs)
    off = _OFF.get(name)
    if off is None:
        off = _OFF[name] = _Off(name, {})
    return off


def span_log() -> list:
    """The newest capture's spans, resolved (``SpanLog.resolve``)."""
    return _LOG.resolve()


def spans_dropped() -> int:
    """How many spans of the newest capture the bounded log left out."""
    return _LOG.dropped


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Profile the body: CPU activity and, where a card is visible, CUDA
    kernels; on exit, also by an exception, the Chrome trace is written to
    ``log_dir/trace_<pid>_<ns>.json`` and the capture's span log to
    ``log_dir/spans_<pid>_<ns>.json`` (``{"dropped": n, "spans": [...]}``;
    the directory is made). Yields the profiler, whose ``key_averages()``
    sums the events."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    capture = _LOG.captures
    try:
        yield prof
    finally:
        prof.stop()
        Path(log_dir).mkdir(parents=True, exist_ok=True)
        stem = f"{os.getpid()}_{time.time_ns()}"
        prof.export_chrome_trace(os.path.join(log_dir, f"trace_{stem}.json"))
        mine = _LOG.capture == capture
        with open(os.path.join(log_dir, f"spans_{stem}.json"), "w", encoding="utf-8") as f:
            json.dump({"dropped": _LOG.dropped if mine else 0,
                       "spans": span_log() if mine else []}, f)


def _count(tensors) -> Tuple[int, int]:
    tensors = list(tensors)
    return (sum(t.numel() for t in tensors),
            sum(t.numel() * t.element_size() for t in tensors))


def param_summary(module: Union[nn.Module, Mapping], title: str = "params") -> str:
    """A table of the parameters and their bytes per top-level submodule (or
    per entry of a mapping of modules) that holds any, and the total: the
    JAX package's table of the same model's params tree."""
    lines = [f"{title:<40} {'params':>12} {'bytes':>14}"]
    children = dict(module.named_children()) if isinstance(module, nn.Module) else dict(module)
    total_n = total_b = 0
    for name, sub in sorted(children.items()):
        n, b = _count(sub.parameters())
        if n == 0:
            continue   # a flax params tree has no entry for a module without parameters
        total_n, total_b = total_n + n, total_b + b
        lines.append(f"{name:<40} {n:>12,} {b:>14,}")
    if isinstance(module, nn.Module):
        # parameters held by the module itself, outside any child
        own = [p for name, p in module.named_parameters(recurse=False)]
        n, b = _count(own)
        total_n, total_b = total_n + n, total_b + b
    lines.append(f"{'TOTAL':<40} {total_n:>12,} {total_b:>14,}")
    return "\n".join(lines)


def _named_tensors(tree: Tree, prefix: str = "") -> Iterator[Tuple[str, torch.Tensor]]:
    if tree is None:
        return
    if isinstance(tree, torch.Tensor):
        yield prefix or "tensor", tree
    elif isinstance(tree, nn.Module):
        for name, t in list(tree.named_parameters()) + list(tree.named_buffers()):
            yield f"{prefix}.{name}" if prefix else name, t
    else:
        for key, sub in tree.items():
            yield from _named_tensors(sub, f"{prefix}.{key}" if prefix else str(key))


@torch.no_grad()
def check_replication(tree: Tree) -> None:
    """Raise unless every parameter and buffer of ``tree`` (a module, a
    tensor, or a mapping of names to them) equals rank 0's copy bit for
    bit. Rank 0's tensors are broadcast (one flat buffer per dtype and
    device) and compared with ``torch.equal``; the first divergent tensor
    in the tree's order is agreed on over the ranks, so every rank raises,
    naming it. A no-op at world size 1."""
    rank, size = world()
    if size == 1:
        return
    named = list(_named_tensors(tree))
    by_key: dict = {}
    for i, (_, t) in enumerate(named):
        by_key.setdefault((t.dtype, t.device), []).append(i)
    first_bad = len(named)
    for indices in by_key.values():
        flat = torch.cat([named[i][1].detach().reshape(-1) for i in indices])
        dist.broadcast(flat, src=0)
        offset = 0
        for i in indices:
            t = named[i][1]
            if not torch.equal(flat[offset:offset + t.numel()].view_as(t), t):
                first_bad = min(first_bad, i)
            offset += t.numel()
    flag = torch.tensor([first_bad], dtype=torch.int64, device=reduce_device())
    dist.all_reduce(flag, op=dist.ReduceOp.MIN)
    bad = int(flag.item())
    if bad < len(named):
        raise AssertionError(f"replication mismatch at {named[bad][0]}: a rank's copy differs "
                             f"from rank 0's (seen on rank {rank} of {size})")
