"""Spans of the port's own phases, stamped on the clock of the profiler's
events.

A span marks one phase of a call at a layer boundary: the dispatch of
``trace_rays``, the slab kernel's preparation and launch, a graph's
capture, a loop of graph replays.  ``span(name)`` is a context manager
that records only while the record is on: while a ``torch.profiler``
session runs (``torch.autograd._profiler_enabled()``), or inside ``with
recording():``, which an operator opens to read phase times without the
profiler's cost.  Off, ``span`` checks that flag (``on()``) and returns the
shared no-op ``NOOP``; nothing else runs.

On, a span
* enters ``torch.profiler.record_function(name)`` while a profiler runs,
  so that it shows in the profiler's trace beside the kernels it
  launched;
* appends a ``Record`` to a list in memory: name, call id, parent (the
  innermost span open on this thread), start and end from
  ``time.time_ns()``, the Unix clock on which the profiler stamps its
  events;
* with ``device`` a CUDA device, and not while the current stream is
  being captured, records a pair of timing events on the device's
  current stream.  They are resolved to milliseconds only when the list
  is read.

A span opened with no span open on its thread and with no ``call`` takes
a fresh call id; spans opened under it take its id.  A phase that runs
on another thread (a backward runs on the autograd engine's device
thread) is given the id of its call (``current_call()`` where the call
began) and has no parent.

Spans go around host loops and dispatch only: never inside a function
that a CUDA graph captures, never around a single replay (the module
counters ``REPLAYS`` count those).

``records()`` returns the closed spans, device times resolved, and may
be called again; ``clear()`` empties the list.  The list keeps at most
``LIMIT`` spans; those beyond are counted in ``dropped`` and not kept.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import threading
import time

import torch

LIMIT = 1_000_000   # spans kept; beyond it they are counted in ``dropped``

dropped = 0
_RECORDS: list = []
_LOCK = threading.Lock()
_LOCAL = threading.local()     # .stack: the spans open on this thread
_CALLS = itertools.count(1)
_IDS = itertools.count(1)
_recording = 0                  # depth of open ``recording()`` blocks
_profiler_enabled = torch.autograd._profiler_enabled


@dataclasses.dataclass
class Record:
    """One span: ``parent`` is the ``id`` of the span open around it on
    its thread (None at the top); times in ns of the Unix clock;
    ``device_ms`` the time on the device's stream between its two events
    (None without a device stamp)."""

    name: str
    call: int
    id: int
    parent: int | None
    start_ns: int = 0
    end_ns: int | None = None
    device_ms: float | None = None
    events: tuple | None = dataclasses.field(default=None, repr=False)


class _Noop:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return None


NOOP = _Noop()


def _stack():
    stack = getattr(_LOCAL, "stack", None)
    if stack is None:
        stack = _LOCAL.stack = []
    return stack


class _Span:
    __slots__ = ("name", "device", "call", "record", "annotation")

    def __init__(self, name, device, call):
        self.name, self.device, self.call = name, device, call
        self.annotation = None

    def __enter__(self):
        global dropped
        stack = _stack()
        parent = stack[-1] if stack else None
        call = self.call
        if call is None:
            call = parent.call if parent is not None else next(_CALLS)
        rec = self.record = Record(self.name, call, next(_IDS),
                                   parent.id if parent is not None else None)
        with _LOCK:
            kept = len(_RECORDS) < LIMIT
            if kept:
                _RECORDS.append(rec)
            else:
                dropped += 1
        # pushed even when not kept, so that the spans under it keep its call
        stack.append(rec)
        if _profiler_enabled():
            self.annotation = torch.profiler.record_function(self.name)
        # stamped just before the profiler's own stamp of the same span
        rec.start_ns = time.time_ns()
        if self.annotation is not None:
            self.annotation.__enter__()
        dev = self.device
        if (kept and dev is not None and dev.type == "cuda"
                and not torch.cuda.is_current_stream_capturing()):
            rec.events = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
            rec.events[0].record(torch.cuda.current_stream(dev))
        return rec

    def __exit__(self, *exc):
        rec = self.record
        if rec.events is not None:
            rec.events[1].record(torch.cuda.current_stream(self.device))
        if self.annotation is not None:
            self.annotation.__exit__(*exc)
        _stack().pop()
        # set last: ``records()`` takes a span once its end is set
        rec.end_ns = time.time_ns()
        return None


def on():
    """Whether spans record now: a profiler runs or ``recording()`` is open."""
    return bool(_recording or _profiler_enabled())


def span(name, device=None, call=None):
    """A context manager around one phase named ``name`` (a static
    string); ``device``: stamp it with CUDA events on that device's
    current stream; ``call``: the call id to take instead of the
    enclosing span's."""
    if not on():
        return NOOP
    return _Span(name, device, call)


def current_call():
    """The call id of the innermost span open on this thread, or None."""
    stack = getattr(_LOCAL, "stack", None)
    return stack[-1].call if stack else None


@contextlib.contextmanager
def recording():
    """Record spans inside this block, with or without a profiler."""
    global _recording
    _recording += 1
    try:
        yield
    finally:
        _recording -= 1


def records():
    """The closed spans in the order they opened, each with its device
    time resolved (this waits for the device to reach its end event)."""
    with _LOCK:
        out = [r for r in _RECORDS if r.end_ns is not None]
    for r in out:
        if r.events is not None:
            r.events[1].synchronize()
            r.device_ms = r.events[0].elapsed_time(r.events[1])
            r.events = None
    return out


def clear():
    """Empty the list and the count of spans dropped."""
    global dropped
    with _LOCK:
        _RECORDS.clear()
        dropped = 0


def self_ns(recs):
    """{id: the span's duration less the part of it that its children
    cover} of closed spans ``recs``."""
    children = {}
    for r in recs:
        if r.parent is not None:
            children.setdefault(r.parent, []).append((r.start_ns, r.end_ns))
    out = {}
    for r in recs:
        covered, reach = 0, r.start_ns
        for s, e in sorted(children.get(r.id, ())):
            s, e = max(s, reach), min(e, r.end_ns)
            if e > s:
                covered += e - s
                reach = e
        out[r.id] = (r.end_ns - r.start_ns) - covered
    return out
