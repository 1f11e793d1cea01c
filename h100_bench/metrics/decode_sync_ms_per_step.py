"""Decoder loop (decode/greedy.py): the host ms of the ``decode.sync`` spans, the
host's wait a step for the count of the rows still running, over the first
traced batch's steps."""

from core import spans

UNIT = "ms"
MOVES = "serve_audio_s_per_s"


def read(run: dict):
    return spans.host_ms_per_step("decode.sync")
