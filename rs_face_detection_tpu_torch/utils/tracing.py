"""Spans and counters of the face-ID path, on while a torch.profiler session runs.

Tracing is on exactly while ``torch.profiler`` profiles this process: the
benchmark's traced sub-window, or a TraceSetting session of the server.
The switch is ``torch.autograd.profiler._is_profiler_enabled``, which the
profiler sets and clears for the whole process.  There is no other switch.

Off, a site costs a call, one attribute read and a branch: ``span`` returns
the shared ``OFF`` object, ``count``, ``host_sync`` and ``record`` return at once.
Nothing is recorded, no CUDA event is made and nothing is allocated.

On, a span:

- reads ``time.perf_counter_ns`` at its start and end (or takes the reads
  its caller made, so that the registry's statistics and the span share
  them), and records ``(name, start_ns, end_ns, thread id, parent span,
  attributes)`` in the store when it ends;
- is opened as ``torch.profiler.record_function(name)``, so that it shows
  in the Chrome trace as a ``user_annotation`` event on the kernels'
  timeline;
- given a CUDA ``device``, records a CUDA event at its start and one at
  ``device_end()``; their milliseconds are read when the store is read,
  after the host copies that follow ``device_end()`` have completed them.

``count`` adds to a counter of the innermost open span of the thread; a
span hands its counts to its parent when it ends, so
``pipeline.extract_batch`` holds its batch's.  ``host_sync`` counts one
call that blocks the host on the stream (utils/device.py makes each: a
pageable upload, a fetch of a stage's results) as ``host_syncs``, only for a
CUDA device: on the CPU nothing waits on a stream.  ``decode_pooled`` counts the
images ``utils/image_io.py::decode_images`` decoded on its pool of threads.

The store holds the newest session: it opens at the first span or record
after the profiler starts, and ``read()`` closes it once the profiler has
stopped, so that the next session starts empty.  It keeps the spans that
began and ended while the profiler ran: one still open at the stop is
counted as ``cut`` instead, since the stop itself (the profiler collecting
its events) can stall it for a second.  It keeps at most
``LIMIT`` spans (the oldest are dropped and counted), so a session left
running cannot grow it without bound.  One ``(time.time_ns(),
perf_counter_ns)`` anchor per session converts its spans to the Chrome
trace's clock (``Snapshot.trace_us``: microseconds since the epoch, the
trace's ``ts`` plus its ``baseTimeNanoseconds``).
"""

from __future__ import annotations

import collections
import itertools
import threading
import time
from typing import Dict, List, Optional

import torch
from torch.autograd import profiler as _profiler

#: Spans a session keeps at most.
LIMIT = 1 << 16


def enabled() -> bool:
    """Whether a torch.profiler session runs in this process."""
    return _profiler._is_profiler_enabled


class _Off:
    """The span of every site while tracing is off: does nothing."""

    __slots__ = ()

    def __enter__(self) -> "_Off":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def __bool__(self) -> bool:
        return False

    def set(self, key: str, value) -> None:
        pass

    def device_end(self) -> None:
        pass

    def end(self, end_ns: int) -> int:
        return end_ns


OFF = _Off()


class Span:
    """One timed stage; use as a context manager (see the module's doc)."""

    __slots__ = ("name", "start_ns", "end_ns", "tid", "id", "parent", "attrs", "counts", "session",
                 "_device", "_events", "_function")

    def __init__(self, name: str, start_ns: Optional[int], device) -> None:
        self.name = name
        self.start_ns = start_ns
        self.end_ns = None
        self.attrs: Dict[str, object] = {}
        self.counts: Dict[str, int] = {}
        self._device = device if device is not None and torch.device(device).type == "cuda" else None
        self._events = None

    def __bool__(self) -> bool:
        return True

    def __enter__(self) -> "Span":
        if self.start_ns is None:
            self.start_ns = time.perf_counter_ns()
        stack = _stack()
        self.parent = stack[-1].id if stack else None
        self.tid = threading.get_ident()
        self.id = next(_ids)
        self.session = _STORE.begin()
        self._function = torch.profiler.record_function(self.name)
        self._function.__enter__()
        if self._device is not None:
            start = torch.cuda.Event(enable_timing=True)
            start.record(torch.cuda.current_stream(self._device))
            self._events = [start, None]
        stack.append(self)
        return self

    def __exit__(self, *exc) -> bool:
        stack = _stack()
        stack.pop()
        self._function.__exit__(*exc)
        if self.end_ns is None:
            self.end_ns = time.perf_counter_ns()
        if stack:
            for key, n in self.counts.items():
                stack[-1].counts[key] = stack[-1].counts.get(key, 0) + n
        if _profiler._is_profiler_enabled:
            _STORE.add(self)
        else:  # it outlasted the session, and the profiler's stop with it
            _STORE.add(self, cut=True)
        return False

    def set(self, key: str, value) -> None:
        """An attribute of the span: an id, an image or face count."""
        self.attrs[key] = value

    def device_end(self) -> None:
        """The end of the span's device work: a CUDA event on the stream,
        just before the host copies that complete it."""
        if self._events is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record(torch.cuda.current_stream(self._device))
            self._events[1] = end

    def end(self, end_ns: int) -> int:
        """Ends the span at the caller's clock read ``end_ns``; returns it."""
        self.end_ns = end_ns
        return end_ns

    @property
    def device_ms(self) -> Optional[float]:
        """Milliseconds between the span's CUDA events; None without them."""
        if self._events is None or self._events[1] is None:
            return None
        start, end = self._events
        if not end.query():
            end.synchronize()
        return float(start.elapsed_time(end))


def span(name: str, start_ns: Optional[int] = None, device=None):
    """A span named ``name`` (a context manager), or ``OFF`` while tracing
    is off.  ``start_ns``: the caller's ``perf_counter_ns`` read at its
    start; ``device``: CUDA events at its start and ``device_end()``."""
    if not _profiler._is_profiler_enabled:
        return OFF
    return Span(name, start_ns, device)


def count(name: str, n: int) -> None:
    """Adds ``n`` to the counter ``name`` of the thread's innermost open
    span and of the session."""
    if not _profiler._is_profiler_enabled:
        return
    stack = _stack()
    if stack:
        counts = stack[-1].counts
        counts[name] = counts.get(name, 0) + n
    _STORE.count(name, n)


def host_sync(device, n: int = 1) -> None:
    """Counts ``n`` calls that block the host on ``device``'s stream."""
    if _profiler._is_profiler_enabled and torch.device(device).type == "cuda":
        count("host_syncs", n)


def record(name: str, start_ns: int, end_ns: int, **attrs) -> None:
    """A span in the store only, not in the Chrome trace: an interval that
    a thread learns of after it ended (a request's wait in a queue)."""
    if not _profiler._is_profiler_enabled:
        return
    s = Span(name, start_ns, None)
    s.end_ns, s.attrs = end_ns, attrs
    s.tid, s.id, s.parent = threading.get_ident(), next(_ids), None
    s.session = _STORE.begin()
    _STORE.add(s)


class Snapshot:
    """The spans and counters of one session, as ``read()`` returns them."""

    def __init__(self, spans: List[Span], counters: Dict[str, int], anchor, dropped: int = 0, cut: int = 0) -> None:
        self.spans, self.counters, self.anchor, self.dropped, self.cut = spans, counters, anchor, dropped, cut

    def named(self, name: str) -> List[Span]:
        return [s for s in self.spans if s.name == name]

    def children(self, parent: Span, name: Optional[str] = None) -> List[Span]:
        return [s for s in self.spans if s.parent == parent.id and (name is None or s.name == name)]

    def trace_us(self, ns: int) -> float:
        """A ``perf_counter_ns`` read on the Chrome trace's clock: microseconds
        since the epoch."""
        wall, perf = self.anchor
        return (wall + ns - perf) / 1e3


class _Store:
    def __init__(self) -> None:
        self.lock = threading.Lock()
        self.session = 0
        self.open = False
        self.anchor = (0, 0)
        self.spans: "collections.deque" = collections.deque(maxlen=LIMIT)
        self.counters: Dict[str, int] = {}
        self.dropped = 0
        self.cut = 0

    def begin(self) -> int:
        """The open session's number; opens a new one if none is open."""
        if not self.open:
            with self.lock:
                if not self.open:
                    self.session += 1
                    self.spans.clear()
                    self.counters = {}
                    self.dropped = self.cut = 0
                    self.anchor = (time.time_ns(), time.perf_counter_ns())
                    self.open = True
        return self.session

    def add(self, s: Span, cut: bool = False) -> None:
        with self.lock:
            if s.session != self.session:
                return
            if cut:
                self.cut += 1
                return
            if len(self.spans) == LIMIT:
                self.dropped += 1
            self.spans.append(s)

    def count(self, name: str, n: int) -> None:
        session = self.begin()
        with self.lock:
            if session == self.session:
                self.counters[name] = self.counters.get(name, 0) + n

    def read(self) -> Snapshot:
        with self.lock:
            if not _profiler._is_profiler_enabled:
                self.open = False
            return Snapshot(list(self.spans), dict(self.counters), self.anchor, self.dropped, self.cut)


_STORE = _Store()
_ids = itertools.count(1)
_local = threading.local()


def _stack() -> List[Span]:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def read() -> Snapshot:
    """The newest session's spans and counters.  Once the profiler has
    stopped, the next span opens a new session."""
    return _STORE.read()


def begin_session() -> None:
    """Starts a new session now (a profiler that has just started): what
    an earlier session left unread is dropped."""
    with _STORE.lock:
        _STORE.open = False
    _STORE.begin()
