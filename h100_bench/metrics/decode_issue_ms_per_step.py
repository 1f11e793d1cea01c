"""Decoder loop (decode/greedy.py): the host ms of a ``decode.step`` span less
its ``decode.sync``, the host's issue of a step, the mean over the first traced
batch's steps."""

from core import spans

UNIT = "ms"
MOVES = "serve_audio_s_per_s"


def read(run: dict):
    return spans.issue_ms_per_step()
