"""The benchmark's tests: ``python -m pytest h100_bench/tests`` from the
root of the checkout. Tests marked ``cuda`` need the card and skip here."""

import pathlib
import sys

HERE = pathlib.Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent), str(HERE.parents[1])]


import pytest  # noqa: E402


@pytest.fixture
def tiny_port(monkeypatch):
    """The port's configurations cut to the tiny cells' size."""
    from tiny import tiny_port as cut

    cut(monkeypatch)
