"""Micro-batch queue (``cli/serve.py:Engine._worker``): percent of the
micro-batch rows that carried a request, the Engine's own list of each
micro-batch's requests (``Engine.batches``) over the micro-batches run
from the window's start to the drain's end, times ``--batch``."""

UNIT = "%"
MOVES = "serve_p95_ms"


def read(run: dict):
    rows = run["stats"].get("batch_rows")
    if not rows:
        return None
    return 100.0 * sum(rows) / (len(rows) * run["stats"]["batch_size"])
