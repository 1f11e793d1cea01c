"""Numerical-health checks: the counterpart of the JAX package's
``utils/debug.py`` (NaN/inf checks and strict shape asserts in the
pipeline)."""

from __future__ import annotations

from typing import Any

import numpy as np
import torch


def _leaves(tree: Any, path: str = ""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}[{i}]")
    elif tree is not None:
        yield path, tree


def finite_check(tree: Any, name: str = "pytree") -> None:
    """Host-side assertion that every floating leaf of a nested dict / list
    of tensors and arrays is finite (bf16 included); raises
    ``FloatingPointError`` naming the bad leaves by their JAX key paths."""
    bad = []
    for path, leaf in _leaves(tree):
        if isinstance(leaf, torch.Tensor):
            if leaf.is_floating_point() and not bool(torch.isfinite(leaf).all()):
                bad.append(path)
            continue
        arr = np.asarray(leaf)
        if np.issubdtype(arr.dtype, np.floating) and not np.isfinite(arr).all():
            bad.append(path)
    if bad:
        raise FloatingPointError(f"non-finite values in {name}: {bad}")


def debug_assert_finite(x: torch.Tensor, name: str = "tensor") -> torch.Tensor:
    """In-stream finite check: queues a device-side assert that fails the
    stream when ``x`` holds NaN/inf, without a host sync (the error surfaces
    at the next sync). On the CPU it raises at once. Returns ``x``."""
    torch._assert_async(torch.isfinite(x).all(), f"non-finite values in {name}")
    return x


def assert_shape(x, shape: tuple, name: str = "tensor") -> None:
    """Static shape assert with wildcard None dims."""
    actual = tuple(x.shape)
    if len(actual) != len(shape) or any(
        e is not None and a != e for a, e in zip(actual, shape)
    ):
        raise ValueError(f"{name}: expected shape {shape}, got {actual}")
