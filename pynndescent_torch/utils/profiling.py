"""Spans, counters and phase timings (``NNDescent(..., profile=True)`` ->
``index.phase_times_``), the counterpart of pynndescent_tpu/utils/profiling.py.

``span(name, device)`` records a named stretch of the program while a
``torch.profiler`` session is active in the process, and does nothing else
otherwise: its one test when tracing is off is the profiler's own flag. A
record holds the host interval on ``time.time_ns()``, the clock of the
profiler's events, so a span can be laid over a trace; its parent and root
(the innermost and outermost spans open when it began: a build's spans share
the ``build`` span's id, a query call's its ``phase/query``'s); the counters
its code added; and, on a CUDA device, a device stretch: CUDA events
recorded on the current stream at entry and exit, with no synchronisation,
resolved by ``spans()`` once the device has passed them. Sibling spans'
stretches tile the stream's timeline, so a span's children add up without
the syncs of ``profile=True``. Records stay in memory (``spans()``,
``clear()``), at most ``SPAN_CAP`` of them: past it ``span`` records
nothing and counts the span in ``dropped()``. A span's CUDA events are
released as soon as the device has passed it, checked whenever a span
ends. While the session profiles CPU activity, each span is also a
``record_function`` range of its name.

``PhaseTimer.phase(name)`` is the span ``phase/<name>``. With ``profile``
truthy it also synchronises the device at each phase edge and sums wall
seconds per phase; when profiling is off no synchronisation is added. A
directory given as ``profile`` additionally records a ``torch.profiler``
trace of the build there.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time

import torch

SPAN_CAP = 1_000_000

# True while a torch.profiler session is active (any activities)
tracing = torch._C._autograd._profiler_enabled
# a record_function range at a tenth of its cost (2 against 18 us a span
# under a CPU profile, on the CPU)
_Range = torch._C._profiler._RecordFunctionFast


class _NullSpan:
    """What ``span`` returns while tracing is off: a context that records
    nothing and a ``count`` that adds to nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def count(self, **n):
        pass


NULL_SPAN = _NullSpan()


class Span:
    """One span: open inside its ``with`` block, a record after it.
    ``device_s`` (the device stretch, seconds) is None until ``spans()``
    finds the device past the span's end, and on a CPU device."""

    __slots__ = ("name", "id", "parent", "root", "start_ns", "end_ns", "counts",
                 "device", "device_s", "_recorder", "_stream", "_events", "_range", "_pending")

    def __init__(self, recorder, name, device):
        self._recorder = recorder
        self.name = name
        self.device = None if device is None else torch.device(device)
        self.counts = {}
        self.device_s = None
        self._stream = self._events = None
        self._pending = []

    def count(self, **n):
        """Add integers to the span's counters. A 0-d tensor is added by
        ``resolve``, once the device is past the span's end: inside an open
        span on a CUDA device it is copied to pinned host memory on the
        span's stream, with no sync."""
        for key, v in n.items():
            if not isinstance(v, torch.Tensor):
                self.counts[key] = self.counts.get(key, 0) + int(v)
                continue
            if v.is_cuda and self._stream is not None:
                host = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
                host.copy_(v, non_blocking=True)
            else:
                host = v.detach().to("cpu", copy=True)
            self._pending.append((key, host))

    def __enter__(self):
        rec = self._recorder
        stack = rec._stack()
        self.id = next(rec._ids)
        self.parent = stack[-1].id if stack else None
        self.root = stack[-1].root if stack else self.id
        stack.append(self)
        if self.device is not None and self.device.type == "cuda":
            self._stream = torch.cuda.current_stream(self.device)
            start = torch.cuda.Event(enable_timing=True)
            start.record(self._stream)
            self._events = (start, None)
        # after the event: the first span of a traced window starts inside
        # the window's first recorded runtime call or after it
        self.start_ns = time.time_ns()
        self._range = _Range(self.name)
        self._range.__enter__()
        return self

    def __exit__(self, *exc):
        self._range.__exit__(*exc)
        self._range = None
        if self._events is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record(self._stream)
            self._stream = None
            self._events = (self._events[0], end)
        self.end_ns = time.time_ns()
        rec = self._recorder
        stack = rec._stack()
        if stack and stack[-1] is self:
            stack.pop()
        elif self in stack:
            stack.remove(self)
        rec._add(self)
        return False

    def resolve(self) -> bool:
        """Read the device stretch from the span's events, and the counters
        its device tensors gave, and let them go, once the device has passed
        its end (no wait). True when the span holds no events any more."""
        if self._events is not None and self._events[1].query():
            start, end = self._events
            self.device_s = start.elapsed_time(end) * 1e-3
            self._events = None
        if self._events is None and self._pending:
            for key, host in self._pending:
                self.counts[key] = self.counts.get(key, 0) + int(host)
            self._pending = []
        return self._events is None

    def __repr__(self):
        return (f"Span({self.name!r}, id={self.id}, parent={self.parent}, root={self.root}, "
                f"{(self.end_ns - self.start_ns) * 1e-6:.3f} ms host, device_s={self.device_s}, "
                f"counts={self.counts})")


class Recorder:
    """A buffer of at most ``SPAN_CAP`` spans. The module's ``span``,
    ``spans``, ``clear`` and ``dropped`` use one process-wide recorder, as
    the profiler session that turns it on is process-wide. It holds every
    span of every session until ``clear()``."""

    def __init__(self):
        self.records: list[Span] = []
        self.dropped = 0
        self._ids = itertools.count(1)
        self._local = threading.local()
        self._lock = threading.Lock()
        self._unresolved = 0  # records before this one hold no CUDA events

    def span(self, name: str, device=None):
        """A span named ``name`` (``with span(...) as s: s.count(k=1)``),
        recorded while a profiler session is active and the buffer has
        room; ``device`` (a CUDA device) gives it a device stretch."""
        if not tracing():
            return NULL_SPAN
        if len(self.records) >= SPAN_CAP:
            with self._lock:
                self.dropped += 1
            return NULL_SPAN
        return Span(self, name, device)

    def spans(self) -> list[Span]:
        """The recorded spans in the order they ended, device stretches
        resolved where the device has passed them (synchronise first)."""
        with self._lock:
            records = list(self.records)
        for s in records:
            s.resolve()
        return records

    def clear(self):
        with self._lock:
            self.records = []
            self.dropped = 0
            self._unresolved = 0

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _add(self, s: Span):
        """Keep ``s`` and resolve the spans the device has passed since the
        last call, in the order they ended, stopping at the first it has not."""
        with self._lock:
            if len(self.records) < SPAN_CAP:
                self.records.append(s)
            else:  # the buffer filled while the span was open
                self.dropped += 1
            i = self._unresolved
            while i < len(self.records) and self.records[i].resolve():
                i += 1
            self._unresolved = i


RECORDER = Recorder()
span = RECORDER.span
spans = RECORDER.spans
clear = RECORDER.clear


def dropped() -> int:
    """Spans left out since the last ``clear()`` because the buffer was full."""
    return RECORDER.dropped


class PhaseTimer:
    """Accumulates wall seconds per named phase. Disabled instances are
    no-ops so the hot path can call them unconditionally."""

    def __init__(self, profile=False, device=None):
        self.enabled = bool(profile)
        self.trace_dir = profile if isinstance(profile, str) else None
        self.device = torch.device(device) if device is not None else None
        self.times: dict[str, float] = {}

    @contextlib.contextmanager
    def phase(self, name):
        """The span ``phase/<name>``, and under ``profile`` its seconds,
        between device synchronisations."""
        self.block()
        t0 = time.perf_counter()
        try:
            with span(f"phase/{name}", self.device) as s:
                try:
                    yield s
                finally:
                    self.block()
        finally:
            if self.enabled:
                self.times[name] = self.times.get(name, 0.0) + time.perf_counter() - t0

    @contextlib.contextmanager
    def trace(self):
        """One profiler trace over the enclosing region (the whole build)."""
        if self.trace_dir is None:
            yield
            return
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device is not None and self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        with torch.profiler.profile(
            activities=acts,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(self.trace_dir),
        ):
            yield

    def block(self):
        """Wait for the device at a phase boundary (no-op when profiling is
        off, or on the CPU, where torch runs synchronously)."""
        if self.enabled and self.device is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
