"""Profiling and throughput accounting: the counterpart of the JAX
package's ``utils/profiling.py``.

  * ``profile_trace(dir)``: a ``torch.profiler`` trace of the CPU and, on a
    card, CUDA activity, written as a Chrome trace (Perfetto)
  * ``StepTimer``: wall-clock accounting with warmup skip, synchronising
    the card on exit (a host clock without a sync times the launch)
  * ``RtfMeter``: the serving metric, processed audio seconds per wall
    second
"""

from __future__ import annotations

import contextlib
import os
import time

import torch


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
