"""Decoder prefill (decode/greedy.py) under the Engine: the device ms of the
program's ``decode.prefill`` span in the first micro-batch traced after the
window."""

from core import spans

UNIT = "ms"
MOVES = "serve_p95_ms"


def read(run: dict):
    return spans.device_ms("decode", "decode.prefill")
