"""Profiling and throughput accounting: the counterpart of the JAX
package's ``utils/profiling.py``.

  * ``profile_trace(dir)``: a ``torch.profiler`` trace of the CPU and, on a
    card, CUDA activity, written as a Chrome trace (Perfetto)
  * ``StepTimer``: wall-clock accounting with warmup skip, synchronising
    the card on exit (a host clock without a sync times the launch)
  * ``RtfMeter``: the serving metric, processed audio seconds per wall
    second
  * ``Clock``: named time marks, CUDA events on a card and the host clock
    on the CPU (the decoders' ``timings``)
  * the tracer: ``span(name, device)`` and ``count(name, n)`` at the layer
    boundaries of the serving and training paths, read back by ``spans()``

The tracer is on exactly while a ``torch.profiler`` session is active
(``profile_trace``, or any ``torch.profiler.profile``): there is no other
switch. Off, ``span`` reads one flag and returns a shared null context, and
``count`` returns at once. On, a span opens a ``record_function`` range of
its name (so it sits in the profiler's trace beside the kernels and names
the host's work there), keeps a record of its host start and end
(``time.perf_counter_ns``), its parent and its root span (the spans of one
decode call or one training step share the root), and the counters added
under the root; with a CUDA ``device`` it also keeps a pair of CUDA events,
resolved to device milliseconds only when ``spans()`` reads them. The
records go in a buffer of ``MAX_SPANS``; later ones are counted as dropped.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import threading
import time

import torch

MAX_SPANS = 65_536
_prof = torch.autograd.profiler   # its _is_profiler_enabled is the tracer's switch
_NULL = contextlib.nullcontext()
_local = threading.local()   # each thread's stack of open spans
_records: list[_Span] = []
_ids = itertools.count()
_dropped = 0


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """Trace the enclosed work; writes ``log_dir/trace.json`` on exit."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class StepTimer:
    """``with timer:`` around each step; the first ``warmup`` steps are not
    kept. ``device``: a CUDA device to synchronise before the clock is read
    on exit (None: the host's work alone)."""

    def __init__(self, warmup: int = 1, device=None):
        self.warmup = warmup
        self.device = device
        self.times: list[float] = []
        self._seen = 0
        self._t = None

    def __enter__(self):
        self._t = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.device is not None and torch.device(self.device).type == "cuda":
            torch.cuda.synchronize(self.device)
        dt = time.perf_counter() - self._t
        self._seen += 1
        if self._seen > self.warmup:
            self.times.append(dt)
        return False

    @property
    def mean(self) -> float:
        return sum(self.times) / len(self.times) if self.times else float("nan")

    @property
    def best(self) -> float:
        return min(self.times) if self.times else float("nan")


class RtfMeter:
    """Accumulates (audio seconds, wall seconds) -> real-time factor."""

    def __init__(self):
        self.audio_s = 0.0
        self.wall_s = 0.0

    def add(self, audio_seconds: float, wall_seconds: float) -> None:
        self.audio_s += audio_seconds
        self.wall_s += wall_seconds

    @property
    def rtf(self) -> float:
        return self.audio_s / self.wall_s if self.wall_s > 0 else float("nan")

    @contextlib.contextmanager
    def timed(self, audio_seconds: float):
        t0 = time.perf_counter()
        yield
        self.add(audio_seconds, time.perf_counter() - t0)


class Clock:
    """Named time marks: CUDA events on a card, the host clock on the CPU."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.marks: dict = {}

    def mark(self, name: str) -> None:
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks[name] = ev
        else:
            self.marks[name] = time.perf_counter()

    def ms(self, a: str, b: str) -> float:
        if self.cuda:
            self.marks[b].synchronize()
            return self.marks[a].elapsed_time(self.marks[b])
        return (self.marks[b] - self.marks[a]) * 1e3


def _stack() -> list[_Span]:
    st = getattr(_local, "stack", None)
    if st is None:
        st = _local.stack = []
    return st


class _Span:
    """One open or closed span; ``span`` makes it, ``spans()`` reads it."""

    __slots__ = ("name", "id", "parent", "root", "start_ns", "end_ns", "counters", "clock",
                 "_range")

    def __init__(self, name: str, device):
        self.name = name
        dev = None if device is None else torch.device(device)
        self.clock = Clock(dev) if dev is not None and dev.type == "cuda" else None
        self.counters: dict[str, int] = {}
        self.end_ns = None

    def __enter__(self):
        global _dropped
        stack = _stack()
        self.parent = stack[-1] if stack else None
        self.root = self.parent.root if self.parent else self
        self.id = next(_ids)
        if len(_records) < MAX_SPANS:
            _records.append(self)
        else:
            _dropped += 1
        stack.append(self)
        self._range = torch.profiler.record_function(self.name)
        self._range.__enter__()
        if self.clock:
            self.clock.mark("start")
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.end_ns = time.perf_counter_ns()
        if self.clock:
            self.clock.mark("end")
        self._range.__exit__(*exc)
        _stack().pop()
        return False


def span(name: str, device=None):
    """A context manager around one layer's work: a traced span while a
    ``torch.profiler`` session is active, else a shared null context.
    ``device``: the device the work runs on; on a CUDA device the span also
    times the work on the card."""
    if not _prof._is_profiler_enabled:
        return _NULL
    return _Span(name, device)


def count(name: str, n: int = 1) -> None:
    """Adds ``n`` to the counter ``name`` of the innermost open span's root
    (nothing while the tracer is off, or outside any span)."""
    if not _prof._is_profiler_enabled:
        return
    stack = getattr(_local, "stack", None)
    if stack:
        c = stack[-1].root.counters
        c[name] = c.get(name, 0) + n


def spans() -> list[dict]:
    """The kept spans in the order they opened: ``id``, ``name``,
    ``parent`` and ``root`` (ids; None for a root's parent), ``host_ms``
    and ``device_ms`` (None while open, and for a span without CUDA
    events; reading it waits for the span's end on the card), and the
    root's ``counters``."""
    out = []
    for s in _records:
        done = s.end_ns is not None
        out.append(dict(id=s.id, name=s.name, parent=s.parent.id if s.parent else None,
                        root=s.root.id,
                        host_ms=(s.end_ns - s.start_ns) * 1e-6 if done else None,
                        device_ms=s.clock.ms("start", "end") if done and s.clock else None,
                        counters=dict(s.counters)))
    return out


def dropped_spans() -> int:
    """Spans not kept since the last ``reset_spans``: the buffer was full."""
    return _dropped


def reset_spans() -> None:
    """Forgets every kept span and the dropped count."""
    global _dropped
    _records.clear()
    _dropped = 0
