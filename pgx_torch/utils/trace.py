"""Spans of the port's own layers, on the profiler's clock.

``span(name, parent=None, **attrs)`` marks one piece of work, as a context
manager or, for a whole function, a decorator::

    with trace.span("train.d_step"):
        ...

    @trace.span("loop.grid")
    def write_grid(...): ...

Spans are off by default.  Off, a span costs a check of this module's flag
and of torch's profiler flag and returns a shared object that does nothing:
it records nothing, allocates nothing and touches no device.  Spans record
after ``enable()`` (until ``disable()``) and whenever a torch profiler
session is active (``torch.profiler.profile`` with any activities, or
``torch.autograd.profiler.emit_nvtx``), so a profiled run records them with
no other switch.

A recorded span holds its name, its start and end in ns on the clock of
torch's Chrome traces (``ts`` x 1000 + ``baseTimeNanoseconds``, which is
``time.time_ns()``), its thread (the native id the profiler writes as
``tid``), its id, its parent's id (the enclosing span on its thread, or the
``parent=`` given, a span or an id, across threads) and its attributes.  On
a CUDA device it also records a pair of timing events on the current
stream; ``spans()`` resolves them into ``device_ms``, the stream's time from
the start marker to the end marker, with one synchronize of each device.  On
the CPU, where work runs as it is called, ``device_ms`` is the host
duration.  Under a profiler session a span also enters
``torch.profiler.record_function(name)``, so it shows in torch's own trace
(and as an NVTX range under ``emit_nvtx``).

``record(name, start_ns, end_ns, ...)`` adds a span whose ends were stamped
elsewhere (``now()``), such as a request's wait from its submit on a
client's thread to its batch's start on the batcher's: it has no device
markers and its ``device_ms`` is None.

Spans are kept in memory in a ring of ``CAPACITY`` records (``dropped()``
counts those pushed out); ``export(path)`` writes them as a Chrome trace of
``X`` events on the same time base, which loads in Perfetto beside a
``torch.profiler`` trace.  No span name starts with ``aten::`` or
``pgx_torch::``: those name torch's operators and the port's kernel ops.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import itertools
import json
import os
import threading
import time
from typing import List, Optional

import torch
import torch.autograd.profiler as _profiler

CAPACITY = 1 << 17
# records whose device markers are resolved as they complete, past this many
_SETTLE_AT = 2048

now = time.time_ns         # the clock of every span, the profiler's


class _Recorder:
    """The process's spans: the switch, the ring, the records whose device
    markers are not yet read, the markers free for reuse (by device), each
    thread's open spans and native id."""

    def __init__(self):
        self.on = False
        self.lock = threading.Lock()
        self.ring: collections.deque = collections.deque(maxlen=CAPACITY)
        self.pending: collections.deque = collections.deque()
        self.free: dict = collections.defaultdict(list)
        self.dropped = 0
        self.ids = itertools.count(1)
        self.local = threading.local()

    def thread(self):
        """(this thread's open spans, its native id): the id read once, a
        system call on some hosts."""
        try:
            return self.local.stack, self.local.tid
        except AttributeError:
            self.local.stack, self.local.tid = [], threading.get_native_id()
            return self.local.stack, self.local.tid

    def marker(self, device: int):
        """A timing event of ``device``: one already read, or a new one
        (created on the device at its first record)."""
        try:
            return self.free[device].pop()
        except IndexError:
            return torch.cuda.Event(enable_timing=True)

    def add(self, rec: "_Span") -> None:
        with self.lock:
            if len(self.ring) == CAPACITY:
                self.dropped += 1
            self.ring.append(rec)
            if rec.events is not None:
                self.pending.append(rec)
                if len(self.pending) > _SETTLE_AT:
                    self._settle()

    def _settle(self) -> None:
        """Read the markers the device has passed, oldest first, without
        waiting for it."""
        while self.pending and self.pending[0].events[1].query():
            self.pending.popleft().resolve()

    def resolve_all(self) -> None:
        with self.lock:
            if not self.pending:
                return
            for dev in {r.device for r in self.pending}:
                torch.cuda.synchronize(dev)
            while self.pending:
                self.pending.popleft().resolve()


_REC = _Recorder()


def active() -> bool:
    """Whether a span opened now records."""
    return _REC.on or _profiler._is_profiler_enabled


def enable() -> None:
    """Record spans from now on, with or without a profiler."""
    _REC.on = True


def disable() -> None:
    """Record spans only under a profiler session (the default)."""
    _REC.on = False


def clear() -> None:
    """Forget every recorded span and the count of those dropped."""
    with _REC.lock:
        _REC.ring.clear()
        _REC.pending.clear()
        _REC.dropped = 0


def dropped() -> int:
    """Spans pushed out of the ring since the last ``clear()``."""
    return _REC.dropped


class _Idle:
    """What a span is while spans are off: one object per name, shared, so
    that a span off allocates nothing; its name is kept for the decorator
    form."""

    __slots__ = ("name",)
    id = None

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def __call__(self, fn):
        return _decorate(self.name, fn)


IDLE = _Idle("")           # a span that is never recorded
_IDLE: dict = {}


def _decorate(name: str, fn):
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with span(name):
            return fn(*args, **kwargs)
    return wrapper


class _Span:
    """A recording span, and then its record."""

    __slots__ = ("name", "parent", "attrs", "id", "thread", "start_ns",
                 "end_ns", "events", "device", "device_ms", "_rf")

    def __init__(self, name: str, parent, attrs: dict):
        self.name = name
        self.parent = getattr(parent, "id", parent)
        self.attrs = attrs
        self.id = None
        self.events = None
        self.device = None
        self.device_ms = None
        self._rf = None
        self.start_ns = self.end_ns = None

    def __call__(self, fn):
        return _decorate(self.name, fn)

    def __enter__(self):
        stack, self.thread = _REC.thread()
        self.id = next(_REC.ids)
        if self.parent is None and stack:
            self.parent = stack[-1].id
        stack.append(self)
        if _profiler._is_profiler_enabled:
            self._rf = torch.profiler.record_function(self.name)
            self._rf.__enter__()
        if (torch.cuda.is_initialized()
                and not torch.cuda.is_current_stream_capturing()):
            self.device = dev = torch.cuda.current_device()
            self.events = (_REC.marker(dev), _REC.marker(dev))
            self.events[0].record()
        self.start_ns = now()
        return self

    def __exit__(self, *exc):
        self.end_ns = now()
        if self.events is not None:
            self.events[1].record()
        else:
            self.device_ms = (self.end_ns - self.start_ns) / 1e6
        if self._rf is not None:
            self._rf.__exit__(*exc)
            self._rf = None
        stack = _REC.thread()[0]
        if stack and stack[-1] is self:
            stack.pop()
        elif self in stack:
            stack.remove(self)
        _REC.add(self)
        return False

    def resolve(self) -> None:
        """Read the device markers (both passed) and free them; under the
        recorder's lock."""
        start, end = self.events
        self.device_ms = start.elapsed_time(end)
        _REC.free[self.device] += self.events
        self.events = None

    def as_dict(self) -> dict:
        return {"name": self.name, "id": self.id, "parent": self.parent,
                "thread": self.thread, "start_ns": self.start_ns,
                "end_ns": self.end_ns, "device_ms": self.device_ms,
                "attrs": self.attrs}


def span(name: str, parent=None, **attrs):
    """A span of ``name`` (context manager or decorator): recorded while
    ``active()``, else the name's shared idle object.  ``parent``: a span
    or a span's id, for a span whose cause ran on another thread.  As a
    decorator, each call of the function is one span of ``name``."""
    if _REC.on or _profiler._is_profiler_enabled:
        return _Span(name, parent, attrs)
    try:
        return _IDLE[name]
    except KeyError:
        return _IDLE.setdefault(name, _Idle(name))


def record(name: str, start_ns: int, end_ns: int, parent=None,
           **attrs) -> None:
    """Add a span whose ends were stamped with ``now()`` elsewhere (on other
    threads, say), if ``active()``.  It has no device markers."""
    if not active():
        return
    rec = _Span(name, parent, attrs)
    rec.id = next(_REC.ids)
    rec.thread = _REC.thread()[1]
    rec.start_ns, rec.end_ns = int(start_ns), int(end_ns)
    _REC.add(rec)


def spans() -> List[dict]:
    """The recorded spans, oldest end first, each a dict of ``name``,
    ``id``, ``parent``, ``thread``, ``start_ns``, ``end_ns``, ``device_ms``
    and ``attrs``.  Synchronizes each device that has markers to read."""
    _REC.resolve_all()
    with _REC.lock:
        return [r.as_dict() for r in _REC.ring]


@contextlib.contextmanager
def recording_to(path: Optional[str]):
    """Spans recorded while the block runs and written to ``path`` when it
    ends, however it ends (a rank r > 0 of a process group writes
    ``path.r``); nothing when ``path`` is empty.  The ``--spans PATH`` of
    the entry points."""
    if not path:
        yield
        return
    enable()
    try:
        yield
    finally:
        disable()
        if (torch.distributed.is_available()
                and torch.distributed.is_initialized()
                and torch.distributed.get_rank() > 0):
            path = f"{path}.{torch.distributed.get_rank()}"
        export(path)


def export(path: str) -> str:
    """Write the recorded spans to ``path`` as a Chrome trace: ``X`` events
    whose ``ts`` x 1000 + ``baseTimeNanoseconds`` is the span's start on
    the profiler's clock (the base: the first span's start, to the whole
    second); ``args`` carry the id, the parent, ``device_ms`` and the
    attributes.  Returns ``path``."""
    recs = spans()
    first = min((r["start_ns"] for r in recs), default=now())
    base_ns = first - first % 1_000_000_000
    pid = os.getpid()
    events = [{"ph": "X", "cat": "pgx_span", "name": r["name"], "pid": pid,
               "tid": r["thread"], "ts": (r["start_ns"] - base_ns) / 1e3,
               "dur": (r["end_ns"] - r["start_ns"]) / 1e3,
               "args": {"id": r["id"], "parent": r["parent"],
                        "device_ms": r["device_ms"], **r["attrs"]}}
              for r in recs]
    with open(path, "w") as f:
        json.dump({"traceEvents": events, "baseTimeNanoseconds": base_ns,
                   "displayTimeUnit": "ms", "droppedSpans": dropped()}, f)
    return path
