"""Device: the share of the device-only traced segment's wall, seconds of
arrivals at the cell's rate after the window, with no operation on the
card."""

from core import readings

UNIT = "%"
MOVES = "serve_p95_ms"


def read(run: dict):
    return readings.idle(run)
