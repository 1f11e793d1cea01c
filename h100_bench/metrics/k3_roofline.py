"""Kernels (ops/): the int8 cross-attention kernel's launches' bound over their
device time in the traced segment."""

from core import readings

UNIT = "%"
MOVES = "serve_audio_s_per_s"


def read(run: dict):
    return readings.roofline(run, "k3")
