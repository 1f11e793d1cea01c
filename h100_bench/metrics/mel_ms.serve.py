"""Log-mel frontend (Pipeline.mel, audio/mel.py, ops/mel_kernel.py): the mean
wall per serving batch between two CUDA events around the program's
``Pipeline.mel``: its staging of the stacked batch on the card and the mel
kernel."""

from core import readings

UNIT = "ms"
MOVES = "serve_audio_s_per_s"


def read(run: dict):
    return readings.mean(run, "mel_ms")
