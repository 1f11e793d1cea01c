"""The real-time-factor meter of the serving entry points: a copy of the JAX
package's ``utils/profiling.RtfMeter``."""

from __future__ import annotations

import contextlib
import time


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
