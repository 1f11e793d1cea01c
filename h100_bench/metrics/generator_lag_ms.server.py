"""The benchmark's own lateness: the 99th percentile over the window's
requests of the ms from a request's due time to its hand-off to
``Engine.submit`` by a client thread."""

import numpy as np

UNIT = "ms"
MOVES = "serve_p95_ms"


def read(run: dict):
    lag = run["stats"].get("lag_ms")
    return float(np.percentile(lag, 99)) if lag else None
