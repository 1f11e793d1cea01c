"""Device: the share of a traced training segment's wall with no operation on the
card."""

from core import readings

UNIT = "%"
MOVES = "train_audio_s_per_s"


def read(run: dict):
    return readings.idle(run)
