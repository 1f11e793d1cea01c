"""Whole training step: the matmul FLOPs of the window's steps (forward, and a
backward of twice it; remat's recompute not counted) over the window's wall
times the bf16 peak."""

from core import readings

UNIT = "%"
MOVES = "train_audio_s_per_s"


def read(run: dict):
    return readings.mfu(run)
