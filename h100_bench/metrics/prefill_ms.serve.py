"""Decoder prefill (decode/greedy.py): the device ms of the program's
``decode.prefill`` span, from the encoder's output to the loop (cross-K/V and
its int8 copy, the cache, the prefix pass, the trie's seeding, the first pick),
in the first traced batch."""

from core import spans

UNIT = "ms"
MOVES = "serve_audio_s_per_s"


def read(run: dict):
    return spans.device_ms("decode", "decode.prefill")
