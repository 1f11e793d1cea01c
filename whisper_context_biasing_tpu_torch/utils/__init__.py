"""Utilities: structured run logging (a copy of the JAX package's
``utils/logging.py``)."""

from .logging import RunLogger

__all__ = ["RunLogger"]
