"""Utilities: structured run logging (a copy of the JAX package's
``utils/logging.py``), the gated Hub sync (``utils/hub.py``), the SRT/WebVTT
writers (``utils/subtitles.py``), the profiler trace, step timer and
real-time-factor meter (``utils/profiling.py``), the decoders' call-signature
counts (``utils/compile_count.py``), the finite and shape checks
(``utils/debug.py``), the FLOPs model (``utils/flops.py``) and the
missing-assets warning of the entry points. The JAX package's
``setup_jax`` and ``effective_platform`` have no counterpart:
``_device.resolve_device`` picks the device."""

import sys

from .compile_count import CountedJit, counted_jit
from .debug import assert_shape, debug_assert_finite, finite_check
from .hub import push_to_hub_if_exists, sync_from_hub, upload_results_to_hub
from .logging import RunLogger
from .profiling import RtfMeter, StepTimer, profile_trace


def warn_missing_assets(vocab_path, weights_path, entry: str = "") -> bool:
    """One-line warning when an entry point runs without real assets
    (docs/REAL_ASSETS.md lists exactly which files unlock full parity).
    Returns True when a warning was printed."""
    missing = []
    if not vocab_path:
        missing.append("byte-fallback vocab (no --vocab/--merges)")
    if not weights_path:
        missing.append("random weights (no checkpoint/safetensors)")
    if missing:
        tag = f"[{entry}] " if entry else ""
        print(f"{tag}WARNING: {' + '.join(missing)} — outputs are NOT real "
              "transcripts; see docs/REAL_ASSETS.md", file=sys.stderr)
    return bool(missing)


__all__ = [
    "CountedJit",
    "counted_jit",
    "RunLogger",
    "RtfMeter",
    "StepTimer",
    "profile_trace",
    "finite_check",
    "debug_assert_finite",
    "assert_shape",
    "warn_missing_assets",
    "sync_from_hub",
    "upload_results_to_hub",
    "push_to_hub_if_exists",
]
