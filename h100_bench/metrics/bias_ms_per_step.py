"""Decoder loop (decode/greedy.py, decode/bias_processor.py): the host ms of the
``decode.bias`` spans inside the steps (the trie's bonus and its advance), over
the first traced batch's steps."""

from core import spans

UNIT = "ms"
MOVES = "serve_audio_s_per_s"


def read(run: dict):
    return spans.host_ms_per_step("decode.bias")
