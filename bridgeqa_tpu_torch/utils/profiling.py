"""Profiling hooks: ``torch.profiler`` traces, per-phase step timers, and
the program's spans and counters (counterpart of
``bridgeqa_tpu/utils/profiling.py``).

The reference only had manual wall-clock timing (``lib/solver.py:524-543``,
``utils/eta.py``); here we add real device traces on demand — set
``BRIDGEQA_PROFILE_DIR`` or pass ``trace_dir`` to capture a timeline of the
host and the card (a Chrome trace, viewable in ``chrome://tracing`` or
Perfetto) of each traced block, and the card's busy share in it.

Spans mark the program's layers (``span(name)``, at the stage boundaries of
the rank forward and of the view selection tool). Off, a span costs a check
of two flags and records nothing. While any ``torch.profiler`` runs, a span
opens a host range ``bridgeqa/<name>`` on the profiler's clock, so the
trace's launch calls, card records and idle gaps can be put down to the
layer that caused them. The range is a plain function range, not a user
annotation, so it puts no annotation record on the card's timeline. Inside
``recording()`` a span also keeps its host interval and, on a card, a CUDA
event pair on the current stream, resolved once when the block ends.
Counters (``count(name, n)``) are always on: a dict increment.
"""

import collections
import contextlib
import dataclasses
import os
import time

import torch
import torch.autograd.profiler as _autograd_profiler
from torch._C._profiler import _RecordFunctionFast


@dataclasses.dataclass
class TraceSummary:
    """What a traced block took: its host wall time, the card's kernel time
    in it (0 without a card), and where its Chrome trace went."""

    wall_ms: float = 0.0
    device_ms: float = 0.0
    path: str = ""

    @property
    def busy(self) -> float:
        """The card's busy share of the block's wall time."""
        return self.device_ms / self.wall_ms if self.wall_ms else 0.0


@contextlib.contextmanager
def maybe_trace(trace_dir=None, *, step: int = 0, enabled=None):
    """Trace the enclosed block with ``torch.profiler`` when enabled; yield a
    ``TraceSummary`` that is filled when the block ends (None when not
    tracing). The card's work is waited for before the block and at its
    end, so the trace holds the block's kernels and no others; the trace is
    written to ``trace_dir/trace_step{step}.json``.

    enabled=None -> auto: on iff trace_dir or BRIDGEQA_PROFILE_DIR is set.
    """
    trace_dir = trace_dir or os.environ.get("BRIDGEQA_PROFILE_DIR")
    if enabled is None:
        enabled = trace_dir is not None
    if not enabled or trace_dir is None:
        yield None
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    cuda = torch.cuda.is_available()
    if cuda:
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    summary = TraceSummary()
    if cuda:  # the card's earlier work stays out of the trace and its busy share
        torch.cuda.synchronize()
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        # the program's spans open their ranges while the profiler runs
        yield summary
        if cuda:
            torch.cuda.synchronize()
        summary.wall_ms = (time.perf_counter() - t0) * 1e3
    summary.device_ms = device_ms(prof.profiler.kineto_results.events())
    os.makedirs(trace_dir, exist_ok=True)
    summary.path = os.path.join(trace_dir, f"trace_step{step}.json")
    prof.export_chrome_trace(summary.path)


def device_ms(events) -> float:
    """The card's kernel, copy and fill time among the profiler's events.
    A user annotation (a ``record_function`` range) is mirrored on the card
    as a record spanning the kernels launched inside it: that record is no
    work of the card's, and counted it would read the whole range as busy,
    so it is left out. Kernels run on one stream, so the rest add up to the
    busy time."""
    return sum(e.duration_ns() for e in events
               if e.device_type() == torch.autograd.DeviceType.CUDA
               and not e.is_user_annotation()) / 1e6


class PhaseTimer:
    """Accumulates wall time per named phase (fetch/forward/backward/eval),
    mirroring the per-iter time report of ``solver.py:573-579``. Host time:
    on the card a phase that only queues work ends before the work does."""

    def __init__(self):
        self.totals = {}
        self.counts = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def means(self) -> dict:
        return {k: self.totals[k] / max(self.counts[k], 1) for k in self.totals}

    def reset(self):
        self.totals.clear()
        self.counts.clear()


PREFIX = "bridgeqa/"  # the profiler ranges' names: PREFIX + the span's name
_NULL = contextlib.nullcontext()
_recorder = None  # the open Recording inside recording(), else None
_counts = collections.Counter()
_event_pool = {}  # card index -> CUDA timing events that recordings reuse


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name``. Always on."""
    _counts[name] += n


def counts() -> collections.Counter:
    """A copy of every counter (a counter never added to reads 0)."""
    return collections.Counter(_counts)


def reset_counts() -> None:
    _counts.clear()


@dataclasses.dataclass
class SpanRecord:
    """One span of a recording. ``parent`` is the index of the enclosing
    span in the recording's ``spans`` (None for a root), ``request`` the
    ordinal of the root span it lies under. ``stream_ms`` (None off the
    card) is the current stream's time between the span's two events; the
    ``self_`` times leave out what the span's children cover. ``start_ns``
    and ``end_ns`` are the host's ``time.perf_counter_ns()``."""

    name: str
    parent: int | None
    request: int
    start_ns: int
    end_ns: int
    host_ms: float
    stream_ms: float | None
    self_host_ms: float
    self_stream_ms: float | None


class Recording:
    """The spans of a ``recording()`` block, in the order they opened
    (``spans``, filled when the block ends), and the counters' increments
    over the block (``counts``)."""

    def __init__(self, cuda: bool):
        self.cuda = cuda
        self.spans: list[SpanRecord] = []
        self.counts = collections.Counter()
        self._raw = []  # [name, parent, request, start_ns, end_ns, event, event]
        self._stack = []
        self._requests = 0
        self._events = 0

    def _event(self):
        pool = _event_pool.setdefault(torch.cuda.current_device(), [])
        if self._events == len(pool):
            pool.append(torch.cuda.Event(enable_timing=True))
        self._events += 1
        return pool[self._events - 1]

    def _resolve(self) -> None:
        if self.cuda and self._raw:
            torch.cuda.synchronize()
        spans = []
        for name, parent, request, t0, t1, e0, e1 in self._raw:
            stream = e0.elapsed_time(e1) if self.cuda else None
            spans.append(SpanRecord(name, parent, request, t0, t1, (t1 - t0) / 1e6, stream,
                                    (t1 - t0) / 1e6, stream))
        for s in spans:
            if s.parent is not None:
                p = spans[s.parent]
                p.self_host_ms -= s.host_ms
                if self.cuda:
                    p.self_stream_ms -= s.stream_ms
        self.spans, self._raw, self._events = spans, [], 0

    def totals(self) -> dict:
        """name -> calls and the sums of each time over its spans (the
        stream's only on a card)."""
        keys = ("host_ms", "self_host_ms") + (("stream_ms", "self_stream_ms") if self.cuda
                                              else ())
        out = {}
        for s in self.spans:
            t = out.setdefault(s.name, {"calls": 0, **dict.fromkeys(keys, 0.0)})
            t["calls"] += 1
            for k in keys:
                t[k] += getattr(s, k)
        return out


class _Span:
    __slots__ = ("rec", "name", "range")

    def __init__(self, rec: Recording, name: str):
        self.rec, self.name = rec, name

    def __enter__(self):
        rec = self.rec
        self.range = _RecordFunctionFast(PREFIX + self.name)
        self.range.__enter__()
        parent = rec._stack[-1] if rec._stack else None
        if parent is None:
            request, rec._requests = rec._requests, rec._requests + 1
        else:
            request = rec._raw[parent][2]
        raw = [self.name, parent, request, time.perf_counter_ns(), 0, None, None]
        if rec.cuda:
            raw[5] = rec._event()
            raw[5].record()
        rec._stack.append(len(rec._raw))
        rec._raw.append(raw)
        return self

    def __exit__(self, *exc):
        rec = self.rec
        raw = rec._raw[rec._stack.pop()]
        if rec.cuda:
            raw[6] = rec._event()
            raw[6].record()
        raw[4] = time.perf_counter_ns()
        self.range.__exit__(None, None, None)
        return False


def span(name: str):
    """A context manager that marks one of the program's layers: a no-op
    while neither a recording nor a profiler is on, the profiler range
    ``bridgeqa/<name>`` while a profiler runs, and a recorded span inside
    ``recording()`` (the module docstring)."""
    if _recorder is None:
        if not _autograd_profiler._is_profiler_enabled:
            return _NULL
        return _RecordFunctionFast(PREFIX + name)
    return _Span(_recorder, name)


@contextlib.contextmanager
def recording():
    """Record every span opened inside the block; yields a ``Recording``
    whose ``spans`` and ``counts`` are filled when the block ends. Where a
    card is present the spans take event pairs on the current stream.
    Nothing syncs or is written until the block ends; recordings do not
    nest."""
    global _recorder
    if _recorder is not None:
        raise RuntimeError("spans are already being recorded")
    rec = Recording(torch.cuda.is_available())
    before = counts()
    _recorder = rec
    try:
        yield rec
    finally:
        _recorder = None
        rec._resolve()
        rec.counts = counts() - before  # counters only grow
