"""Kernels (ops/): the flash forward kernel's launches' bound over their device
time in a traced training segment (remat's recomputed forwards included)."""

from core import readings

UNIT = "%"
MOVES = "train_audio_s_per_s"


def read(run: dict):
    return readings.roofline(run, "k2")
