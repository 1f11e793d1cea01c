"""ctypes bindings for the native (C++) host audio runtime.

The port's copy of the JAX package's ``audio/native.py``: ``native/wcb_native.cpp``
(WAV decode, windowed-sinc resampling, a multithreaded batch loader) is
built with the repo's ``native/Makefile`` (g++, no external dependencies)
at first use. This is host code, not a kernel: where the toolchain is
missing or the build fails, every entry point reports it and ``audio.io``
decodes with the pure-Python path, as the JAX module documents.

The library is built under its own name, ``native/libwcb_native_torch.so``
(``.gitignore`` lists ``native/*.so``), through a temporary file renamed
into place, so that a build here never leaves a half-written library where
another process (the JAX package's loader) may be opening its own.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_NATIVE_DIR = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "..", "native"))
_SRC = os.path.join(_NATIVE_DIR, "wcb_native.cpp")
_SO_PATH = os.path.join(_NATIVE_DIR, "libwcb_native_torch.so")

_lib = None
_lock = threading.Lock()
_build_failed = False


def _build() -> bool:
    tmp = f"libwcb_native_torch.{os.getpid()}.tmp.so"
    try:
        subprocess.run(["make", "-s", "-C", _NATIVE_DIR, f"SO={tmp}"],
                       check=True, capture_output=True, timeout=120)
        os.replace(os.path.join(_NATIVE_DIR, tmp), _SO_PATH)
        return True
    except Exception:
        return False
    finally:
        if os.path.exists(os.path.join(_NATIVE_DIR, tmp)):
            os.remove(os.path.join(_NATIVE_DIR, tmp))


def load_library():
    """The loaded library, or None (no toolchain, or the build failed)."""
    global _lib, _build_failed
    with _lock:
        if _lib is not None:
            return _lib
        if _build_failed:
            return None
        stale = (os.path.isfile(_SO_PATH) and os.path.isfile(_SRC)
                 and os.path.getmtime(_SRC) > os.path.getmtime(_SO_PATH))
        if not os.path.isfile(_SO_PATH) or stale:
            if not _build() and not os.path.isfile(_SO_PATH):
                _build_failed = True
                return None
        try:
            lib = ctypes.CDLL(_SO_PATH)
            lib.wcb_decode_audio.restype = ctypes.c_long
            lib.wcb_decode_audio.argtypes = [
                ctypes.c_char_p, ctypes.c_int, ctypes.POINTER(ctypes.c_float), ctypes.c_long,
                ctypes.POINTER(ctypes.c_long)]
            lib.wcb_decode_batch.restype = ctypes.c_long
            lib.wcb_decode_batch.argtypes = [
                ctypes.POINTER(ctypes.c_char_p), ctypes.c_long, ctypes.c_int, ctypes.c_long,
                ctypes.POINTER(ctypes.c_float), ctypes.c_int]
            lib.wcb_resample.restype = ctypes.c_long
            lib.wcb_resample.argtypes = [
                ctypes.POINTER(ctypes.c_float), ctypes.c_long, ctypes.c_int, ctypes.c_int,
                ctypes.POINTER(ctypes.c_float), ctypes.c_long]
            lib.wcb_last_error.restype = ctypes.c_char_p
        except (OSError, AttributeError) as e:
            # a truncated or incompatible binary: the Python decoders take over
            print(f"[native] unusable {_SO_PATH}: {e}; using Python decoders")
            _build_failed = True
            return None
        _lib = lib
        return _lib


def available() -> bool:
    return load_library() is not None


def decode_audio(path: str, sample_rate: int = 16000, max_len: int = 30 * 16000 * 20
                 ) -> np.ndarray:
    """Decode one WAV to mono float32 at ``sample_rate`` (native path)."""
    lib = load_library()
    if lib is None:
        raise RuntimeError("native library unavailable")
    buf = np.empty(max_len, np.float32)
    actual = ctypes.c_long(0)
    n = lib.wcb_decode_audio(path.encode(), sample_rate,
                             buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), max_len,
                             ctypes.byref(actual))
    if n < 0:
        raise RuntimeError(lib.wcb_last_error().decode())
    if actual.value > max_len:
        # longer than the buffer: the caller falls back to the Python decoder
        # rather than truncating
        raise RuntimeError(f"audio exceeds native decode capacity ({actual.value} > {max_len} "
                           f"samples)")
    return buf[:n].copy()


def decode_batch(paths: list[str], sample_rate: int = 16000, fixed_len: int = 480000,
                 num_threads: int = 0) -> np.ndarray:
    """Parallel decode of N files into a (N, fixed_len) zero-padded or
    trimmed float32 array (the 30 s window contract)."""
    lib = load_library()
    if lib is None:
        raise RuntimeError("native library unavailable")
    n = len(paths)
    out = np.zeros((n, fixed_len), np.float32)
    arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    rc = lib.wcb_decode_batch(arr, n, sample_rate, fixed_len,
                              out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), num_threads)
    if rc != 0:
        raise RuntimeError(f"batch decode failed at {paths[rc - 1]}: "
                           f"{lib.wcb_last_error().decode()}")
    return out
