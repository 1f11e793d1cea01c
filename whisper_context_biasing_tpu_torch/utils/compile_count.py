"""Call-signature counts of the decode entry points: the counterpart of the
JAX package's ``utils/compile_count.py``.

JAX compiles one XLA program per distinct (shape, dtype, static value) call
signature of a jitted function, and its ``CountedJit`` counts those
signatures at the call boundary. The port runs its decoders eagerly, so no
program is compiled; the same count says how many programs a captured
version of each entry point (CUDA graphs, ROADMAP A.0) would hold, and the
eval loop's static-shape diagnostic reads it as JAX's does.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
from torch import nn


def _leaf_key(x):
    if isinstance(x, torch.Tensor):
        return ("tensor", tuple(x.shape), str(x.dtype), x.device.type)
    if isinstance(x, np.ndarray):
        return ("array", tuple(x.shape), str(x.dtype))
    if isinstance(x, nn.Module):
        # the weights' shapes and dtypes, and the model's config (a static
        # argument in JAX)
        return ("module", type(x).__name__, repr(getattr(x, "cfg", None)),
                tuple((n, tuple(t.shape), str(t.dtype)) for n, t in x.state_dict().items()))
    if isinstance(x, dict):
        return ("dict", tuple((k, _leaf_key(v)) for k, v in sorted(x.items(), key=repr)))
    if isinstance(x, (list, tuple)):
        return (type(x).__name__, tuple(_leaf_key(v) for v in x))
    if x is None or isinstance(x, (bool, int, float, str, torch.dtype, torch.device)):
        return ("py", repr(x))  # a static value: part of the key
    return ("obj", type(x).__name__)  # a generator, a tokenizer: its type only


class CountedJit:
    """``fn`` plus a public ``cache_size()``: the distinct call signatures
    it has seen."""

    def __init__(self, fn):
        self._fn = fn
        self._signatures: set = set()
        functools.update_wrapper(self, fn)

    @staticmethod
    def _key(args, kwargs):
        return (_leaf_key(args), _leaf_key(kwargs))

    def __call__(self, *args, **kwargs):
        out = self._fn(*args, **kwargs)
        # recorded after a call that returned: a failed call counts nothing
        self._signatures.add(self._key(args, kwargs))
        return out

    def cache_size(self) -> int:
        """Distinct call signatures seen."""
        return len(self._signatures)

    def clear_cache(self) -> None:
        """Forget the signatures seen."""
        self._signatures.clear()


def counted_jit(fn=None):
    """``CountedJit(fn)``; usable as a decorator."""
    if fn is None:
        return CountedJit
    return CountedJit(fn)
