"""Kernels (ops/): the flash backward kernels' launches' bound over their device
time in a traced training segment."""

from core import readings

UNIT = "%"
MOVES = "train_audio_s_per_s"


def read(run: dict):
    return readings.roofline(run, "k4")
