"""Micro-batch queue (``cli/serve.py:Engine._worker``): the mean host ms of
one micro-batch's device task on the worker (host preparation, the
card's work and the tokens back), from the Engine's own accounting
(``Engine.rtf``'s wall seconds and ``Engine.batches``) over the
micro-batches run from the window's start to the drain's end."""

UNIT = "ms"
MOVES = "serve_p95_ms"


def read(run: dict):
    rows = run["stats"].get("batch_rows")
    if not rows:
        return None
    return 1e3 * run["stats"]["batch_wall_s"] / len(rows)
