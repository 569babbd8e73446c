"""Spans and counters of the port, and the Chrome trace exporter.

Counterpart of the JAX package's utils/profiling.py (the reference's GPU
timestamp query pairs per frame, 1 Hz statistics log and debug labels
for capture tools), rebuilt as one tracer:

* `span(name, frame=None, **attrs)` — a context manager recording the
  stage it wraps: name, start and end in ns, the index of its parent
  (the innermost span open on the same thread), the thread, the
  renderer's frame index and small scalar attrs. `frame` defaults to
  the parent's, and to -1 outside any span (upload, kernel build);
* `count(name, n=1, **labels)` — adds host-known integers to a counter
  keyed by name and labels. A counter adds no device work and no host
  synchronization;
* `enable()` / `disable()` / `enabled()` — the switch, off by default.
  While off, `span` returns one shared no-op context manager and
  `count` returns at once: neither reads a clock nor allocates;
* `spans()` / `counters()` — snapshots; `reset()` clears both;
  `dump(path)` writes them as JSON lines;
* `trace()` — a `torch.profiler` window over the block (CPU, and CUDA
  where the card is there), exported as a Chrome trace into `log_dir`
  (the capture-tool analog). Spans are on inside it, and each also
  enters `torch.profiler.record_function(name)`, so the exported trace
  shows the program's stages; outside it spans never touch the
  profiler.

The clock is `time.time_ns()`, the clock torch.profiler's kineto events
carry, so a device operation's launch event can be joined to the span
that was open on the host when it was launched. Spans are kept in a
buffer of SPAN_CAPACITY; the oldest drop first and the counter
`spans.dropped` counts them.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import json
import os
import threading
import time
from typing import NamedTuple

import torch

SPAN_CAPACITY = 1 << 16


class Span(NamedTuple):
    index: int   # order in which the spans were opened, from 0 after reset()
    name: str
    start: int   # ns, time.time_ns()
    end: int
    parent: int  # index of the enclosing span on the same thread, -1 if none
    thread: int  # native thread id
    frame: int   # the renderer's frame index, -1 outside a frame
    attrs: dict


_on = False
_chrome = False
_lock = threading.Lock()
_local = threading.local()
_spans: collections.deque = collections.deque(maxlen=SPAN_CAPACITY)
_counters: dict = {}
_next_index = itertools.count()


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


NO_SPAN = _NoSpan()


def _thread_state() -> tuple:
    """This thread's stack of open spans and its native id (read once:
    it is a system call)."""
    state = getattr(_local, "state", None)
    if state is None:
        state = _local.state = ([], threading.get_native_id())
    return state


class _Span:
    __slots__ = ("name", "frame", "attrs", "index", "parent", "start", "label",
                 "stack", "thread")

    def __init__(self, name, frame, attrs):
        self.name, self.frame, self.attrs = name, frame, attrs
        self.label = None

    def __enter__(self):
        stack, self.thread = _thread_state()
        self.stack = stack
        self.parent, parent_frame = stack[-1] if stack else (-1, -1)
        if self.frame is None:
            self.frame = parent_frame
        self.index = next(_next_index)
        stack.append((self.index, self.frame))
        if _chrome:
            self.label = torch.profiler.record_function(self.name)
            self.label.__enter__()
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        if self.label is not None:
            self.label.__exit__(*exc)
        self.stack.pop()
        record = Span(self.index, self.name, self.start, end, self.parent,
                      self.thread, self.frame, self.attrs)
        with _lock:
            if len(_spans) == SPAN_CAPACITY:
                key = ("spans.dropped", ())
                _counters[key] = _counters.get(key, 0) + 1
            _spans.append(record)
        return False


def span(name: str, frame: int | None = None, **attrs):
    """A context manager recording one span while tracing is on; the
    shared no-op NO_SPAN while it is off."""
    if not _on:
        return NO_SPAN
    return _Span(name, frame, attrs)


def count(name: str, n: int = 1, **labels) -> None:
    """Add `n` (a host-known integer) to the counter of `name` and
    `labels` while tracing is on."""
    if not _on:
        return
    key = (name, tuple(sorted(labels.items())))
    with _lock:
        _counters[key] = _counters.get(key, 0) + int(n)


def enable() -> None:
    global _on
    _on = True


def disable() -> None:
    global _on
    _on = False


def enabled() -> bool:
    return _on


def reset() -> None:
    """Drop every recorded span and counter; span indices restart at 0."""
    global _next_index
    with _lock:
        _spans.clear()
        _counters.clear()
        _next_index = itertools.count()


def spans() -> list[Span]:
    """The recorded spans, in the order they closed."""
    with _lock:
        return list(_spans)


def counters() -> list[dict]:
    """The counters: one {"name", "labels", "value"} each."""
    with _lock:
        items = list(_counters.items())
    return [{"name": name, "labels": dict(labels), "value": value}
            for (name, labels), value in items]


def dump(path: str) -> None:
    """Write the spans, then the counters, as JSON lines: each span line
    is {"span": Span fields}, each counter line {"counter": ...}."""
    with open(path, "w") as f:
        for s in spans():
            f.write(json.dumps({"span": s._asdict()}) + "\n")
        for c in counters():
            f.write(json.dumps({"counter": c}) + "\n")


@contextlib.contextmanager
def trace(log_dir: str = "./out/profile"):
    """Profile everything inside the block, with spans on and drawn as
    named ranges; on exit write `log_dir`/trace.json (chrome://tracing,
    Perfetto). Yields log_dir."""
    from torch.profiler import ProfilerActivity, profile

    global _on, _chrome
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    was_on = _on
    with profile(activities=activities) as prof:
        _on, _chrome = True, True
        try:
            yield log_dir
        finally:
            _on, _chrome = was_on, False
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
