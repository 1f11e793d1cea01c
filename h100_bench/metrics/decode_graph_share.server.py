"""Decoder loop (decode/greedy.py) under the Engine: the share of the first
micro-batch traced after the window's steps that a replay of the captured
decode step ran, the counter ``decode.graph_steps`` over the steps.
Nothing where the program keeps no such counter."""

from core import spans

UNIT = "%"
MOVES = "serve_p95_ms"


def read(run: dict):
    d = spans.decode_steps()
    if not d or "decode.graph_steps" not in d["counters"]:
        return None
    return 100.0 * d["counters"]["decode.graph_steps"] / d["n"]
