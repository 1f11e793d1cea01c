"""Decoder loop (decode/greedy.py): the sum of greedy_decode's decode_ms over the
sum of its steps, over the window."""

from core import readings

UNIT = "ms"
MOVES = "serve_audio_s_per_s"


def read(run: dict):
    return readings.ratio(run, "decode_ms", "steps")
