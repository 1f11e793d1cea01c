"""Encoder (models/whisper.py:encode_audio): greedy_decode's timings["encode_ms"]
(CUDA events), the mean per serving batch."""

from core import readings

UNIT = "ms"
MOVES = "serve_audio_s_per_s"


def read(run: dict):
    return readings.mean(run, "encode_ms")
