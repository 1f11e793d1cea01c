"""Decoder loop (decode/greedy.py): the share of the first traced batch's
row-steps spent on rows still running, the counter ``decode.live_rows`` over
the steps times the counter ``decode.rows``."""

from core import spans

UNIT = "%"
MOVES = "serve_audio_s_per_s"


def read(run: dict):
    return spans.live_row_share()
