"""Decoder loop (decode/greedy.py) under the Engine: the host ms of the
``decode.sync`` spans, the host's wait a step for the count of the rows
still running, over the steps of the first micro-batch traced after the
window."""

from core import spans

UNIT = "ms"
MOVES = "serve_p95_ms"


def read(run: dict):
    return spans.host_ms_per_step("decode.sync")
