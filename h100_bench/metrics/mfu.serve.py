"""Whole serving batch: the matmul FLOPs of the window's requests (core/counts.py)
over the window's wall times the bf16 peak."""

from core import readings

UNIT = "%"
MOVES = "serve_audio_s_per_s"


def read(run: dict):
    return readings.mfu(run)
