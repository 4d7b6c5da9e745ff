"""The program's spans: host time at each layer boundary of a training
iteration, and the device's clock at the top-level ones.

    from pql_tpu_torch.utils import trace

    trace.iteration(device)          # on entry to an agent's train_iter
    with trace.span("env.sim"):      # a layer boundary
        ...
    trace.count("env.graph_replays")  # a counter of the current iteration
    trace.counters()                 # the current iteration's counters
    trace.recent()                   # the last RING iterations' records

A span records its name, its parent span, the iteration it belongs to and
its host start and end (``time.perf_counter_ns``); its self time is its
duration minus the part its child spans cover. Its layer is the part of its
name before the first dot (``env``, ``replay``, ``learner``).

**The device's clock.** In an iteration on a CUDA device, ``iteration``
records a CUDA event, and every top-level span records one at its entry and
one at its exit, on the current stream. The device-clock ms between a
span's two events is the device's time on the work the span launched plus
the time the stream sat empty in between; the stream can only sit empty
there while the host is still inside the span, so that idle belongs to the
span's layer. What lies between one ``iteration`` event and the next,
outside the top-level spans, is the ``iteration`` layer (the draws, the
metrics, the loop). Events come from a pool. The hot path only records
them: ``recent`` reads the closed records whose events all report
``query()`` true (never waiting, or after a synchronize with
``recent(sync=True)``), and a record that leaves the ring unread returns
its events to the pool. No event is recorded while the current stream
captures a graph. Spans before the first ``iteration`` (set-up, warm-up)
and ``setup.*`` spans record host time only.

**Off and profiled.** ``enable(False)`` makes every span one shared no-op
context. While a ``torch.profiler`` runs, each span also opens a
``record_function`` named ``pql:<span>``, so the spans sit on the profile's
own clock, and a record notes whether its iteration was profiled.

The tracer follows the training loop's thread; spans opened on another
thread are not kept apart from it.
"""

from __future__ import annotations

import collections
import statistics
import time

import torch
import torch.autograd.profiler as _profiler

RING = 16  # iterations kept
MAX_SPANS = 4096  # spans a record keeps (a loop that never calls ``iteration`` fills one)
PREFIX = "pql:"  # of the profiler ranges the spans open
HOST_ONLY = "setup."  # spans with this prefix never record events

_on = True


class SpanRecord:
    """One span: ``parent`` is the index of the enclosing span in the same
    record (-1 at the top level); ``dev`` the device-clock ms of its entry
    and exit after the iteration's start, once read."""

    __slots__ = ("name", "parent", "start_ns", "end_ns", "enter_ev", "exit_ev", "dev")

    def __init__(self, name: str, parent: int):
        self.name, self.parent = name, parent
        self.start_ns = self.end_ns = 0
        self.enter_ev = self.exit_ev = self.dev = None


class Record:
    """The spans and counters of one iteration (``iteration`` ≥ 0), or of
    what ran before the first one (``iteration`` -1)."""

    def __init__(self, iteration: int, profiled: bool = False, start_ev=None):
        self.iteration = iteration
        self.profiled = profiled
        self.spans: list[SpanRecord] = []
        self.counters: dict[str, int] = {}
        self.closed = False  # the next iteration has begun
        self.clock = start_ev is not None  # every top-level span has its events
        self.start_ev, self.end_ev = start_ev, None
        self.period_ms: float | None = None  # device clock, from this iteration's event to the next

    def host_ms(self) -> dict[str, float]:
        """Host self ms by span name, summed over the span's calls."""
        child = [0] * len(self.spans)
        for s in self.spans:
            if s.parent >= 0 and s.end_ns:
                child[s.parent] += s.end_ns - s.start_ns
        out: dict[str, float] = {}
        for s, c in zip(self.spans, child):
            if s.end_ns:
                out[s.name] = out.get(s.name, 0.0) + (s.end_ns - s.start_ns - c) / 1e6
        return out

    def device_ms(self) -> dict[str, float] | None:
        """Device-clock ms by layer: each layer's top-level spans, and
        ``iteration`` the rest of the period. None where the record has no
        device clock (a CPU run, an open or unread iteration)."""
        if self.period_ms is None:
            return None
        out: dict[str, float] = {}
        for s in self.spans:
            if s.parent < 0 and s.dev is not None:
                layer = s.name.split(".", 1)[0]
                out[layer] = out.get(layer, 0.0) + s.dev[1] - s.dev[0]
        out["iteration"] = self.period_ms - sum(out.values())
        return out


class _Tracer:
    def __init__(self):
        self.records: collections.deque[Record] = collections.deque(maxlen=RING)
        self.record = Record(-1)
        self.records.append(self.record)
        self.stack: list[tuple[SpanRecord, int]] = []  # the open spans and their indices
        self.pending: collections.deque[Record] = collections.deque()  # closed, events not yet read
        self.pool: list = []
        self.next_iteration = 0
        self.stream = self.raw_stream = self.device_index = None  # the iteration's stream

    def event(self):
        """A pooled timing event recorded on the current stream; None (and
        the record loses its clock) while the stream captures."""
        if torch.cuda.is_current_stream_capturing():
            self.record.clock = False
            return None
        ev = self.pool.pop() if self.pool else torch.cuda.Event(enable_timing=True)
        if torch._C._cuda_getCurrentRawStream(self.device_index) == self.raw_stream:
            ev.record(self.stream)  # the iteration's stream is still the current one: no new Stream object
        else:
            ev.record()
        return ev

    def recycle(self, rec: Record, read: bool) -> None:
        """Return a record's events to the pool, but its end event, which
        starts the next record; ``read`` first stores their device times."""
        base = rec.start_ev
        if read:
            rec.period_ms = base.elapsed_time(rec.end_ev)
        for s in rec.spans:
            if s.enter_ev is not None:
                if read:
                    s.dev = (base.elapsed_time(s.enter_ev), base.elapsed_time(s.exit_ev))
                self.pool += (s.enter_ev, s.exit_ev)
                s.enter_ev = s.exit_ev = None
        self.pool.append(base)  # the previous record, handled before this one, no longer needs it
        rec.start_ev = rec.end_ev = None

    def harvest(self) -> None:
        """Read the closed records whose events have all completed, oldest
        first; never waits."""
        while self.pending:
            rec = self.pending[0]
            events = [rec.end_ev, rec.start_ev] + [e for s in rec.spans if s.enter_ev is not None
                                                   for e in (s.enter_ev, s.exit_ev)]
            if not all(ev.query() for ev in events):
                return
            self.recycle(self.pending.popleft(), read=True)


_tracer = _Tracer()


class _Span:
    __slots__ = ("name", "entry", "rf")

    def __init__(self, name: str):
        self.name, self.entry, self.rf = name, None, None

    def __enter__(self):
        t = _tracer
        if _profiler._is_profiler_enabled:
            self.rf = torch.autograd.profiler.record_function(PREFIX + self.name)
            self.rf.__enter__()
        rec = t.record
        e = self.entry = SpanRecord(self.name, t.stack[-1][1] if t.stack else -1)
        e.start_ns = time.perf_counter_ns()
        if len(rec.spans) < MAX_SPANS:
            if e.parent < 0 and rec.clock and not self.name.startswith(HOST_ONLY):
                e.enter_ev = t.event()
            rec.spans.append(e)
            t.stack.append((e, len(rec.spans) - 1))
        return self

    def __exit__(self, *exc):
        e, t = self.entry, _tracer
        if e.enter_ev is not None:
            e.exit_ev = t.event()
        e.end_ns = time.perf_counter_ns()
        if t.stack and t.stack[-1][0] is e:
            t.stack.pop()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        return False

    @property
    def seconds(self) -> float | None:
        """Host seconds of the span, once it has ended."""
        e = self.entry
        return None if e is None or not e.end_ns else (e.end_ns - e.start_ns) / 1e9


class _NoSpan:
    """The shared span of a disabled tracer."""

    seconds = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP = _NoSpan()


def enable(on: bool = True) -> None:
    """Turn the tracer on or off for every later span, count and iteration."""
    global _on
    _on = bool(on)


def span(name: str):
    """A context that records the span ``name`` in the current iteration."""
    if not _on:
        return _NOOP
    return _Span(name)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the current iteration's counter ``name``."""
    if _on:
        counters = _tracer.record.counters
        counters[name] = counters.get(name, 0) + n


def counters() -> dict[str, int]:
    """The current iteration's counters: the record's own dict."""
    return _tracer.record.counters


def iteration(device: torch.device | str | None = None) -> None:
    """Start the next iteration's record: on a CUDA ``device``, with an
    event on its current stream that ends the previous iteration's device
    period and starts this one's."""
    if not _on:
        return
    t = _tracer
    ev = None
    if device is not None and torch.device(device).type == "cuda":
        index = torch.device(device).index
        t.device_index = torch.cuda.current_device() if index is None else index
        t.stream = torch.cuda.current_stream(t.device_index)
        t.raw_stream = t.stream.cuda_stream
        ev = t.event()
    prev = t.record
    prev.closed = True
    if prev.clock and ev is not None:
        prev.end_ev = ev
        t.pending.append(prev)
        if len(t.pending) > RING:  # left the ring unread
            t.recycle(t.pending.popleft(), read=False)
    rec = Record(t.next_iteration, bool(_profiler._is_profiler_enabled), ev)
    t.next_iteration += 1
    t.records.append(rec)
    t.record = rec
    t.stack.clear()


def recent(sync: bool = False) -> list[Record]:
    """The kept records, oldest first, after reading every closed record
    whose events have completed; ``sync`` synchronizes the device first."""
    t = _tracer
    if sync and t.pending:
        torch.cuda.synchronize()
    t.harvest()
    return list(t.records)


def reset() -> None:
    """Forget every record (the tracer's state at import)."""
    global _tracer
    _tracer = _Tracer()


def log_values(records: list[Record]) -> dict[str, float]:
    """The operator's log of closed, unprofiled iterations: medians of each
    span's host self ms (``trace/<span>.host_ms``), each layer's device-clock
    ms (``trace/<layer>.device_ms``, ``iteration`` included) and period
    (``trace/period_ms``), and each counter per iteration."""
    rows = [r for r in records if r.iteration >= 0 and r.closed and not r.profiled]
    values: dict[str, list[float]] = {}
    for r in rows:
        dev = r.device_ms()
        parts = [(f"{k}.host_ms", v) for k, v in r.host_ms().items()]
        parts += [(k, float(v)) for k, v in r.counters.items()]
        if dev is not None:
            parts += [(f"{k}.device_ms", v) for k, v in dev.items()] + [("period_ms", r.period_ms)]
        for k, v in parts:
            values.setdefault(k, []).append(v)
    return {f"trace/{k}": statistics.median(v) for k, v in sorted(values.items())}
