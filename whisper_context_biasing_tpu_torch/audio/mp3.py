"""MP3 (MPEG Layer III) decoding for the corpus audio: a copy of the JAX
package's ``audio/mp3.py``.

The reference ingests the corpus's ``.mp3`` files through
``librosa.load(path, sr=16000)`` in its data loader, with a PyAV
fallback — i.e. it delegates MPEG decoding to a system
codec library. This module provides the same capability as a zero-dependency
ctypes binding to ``libmpg123`` (the de-facto free MPEG audio decoder, present
on virtually every Linux host and vendored by common wheels such as pygame),
searched at runtime:

  1. ``WCB_MPG123_PATH`` env override
  2. ``ctypes.util.find_library("mpg123")`` (ldconfig)
  3. well-known sonames / wheel-vendored copies (``pygame.libs``)

Decoded output is float32 PCM at the stream's native rate; ``audio.io``'s
``load_audio`` performs the mono downmix and polyphase resample to 16 kHz,
matching the librosa contract. Registered in ``audio.io.EXTRA_DECODERS`` at
package import, so every ``file`` key in the reference jsonl corpora
(§2.2 SURVEY.md — all ``.mp3``) is loadable end-to-end. Without the library,
decoding an ``.mp3`` raises ``RuntimeError``; nothing is skipped.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import glob
import os
import sys
import threading

import numpy as np

# mpg123 API constants (mpg123.h, stable public ABI)
_MPG123_OK = 0
_MPG123_DONE = -12
_MPG123_NEW_FORMAT = -11
_MPG123_ADD_FLAGS = 2
_MPG123_FORCE_FLOAT = 0x400
_MPG123_QUIET = 0x20

_lib = None
_lock = threading.Lock()
_load_error: str | None = None


def _candidate_paths() -> list[str]:
    cands: list[str] = []
    env = os.environ.get("WCB_MPG123_PATH")
    if env:
        cands.append(env)
    found = ctypes.util.find_library("mpg123")
    if found:
        cands.append(found)
    cands += ["libmpg123.so.0", "libmpg123.so", "libmpg123.dylib"]
    # wheel-vendored copies (e.g. pygame.libs) as a last resort
    for sp in sys.path:
        if sp and os.path.isdir(sp):
            cands += sorted(glob.glob(os.path.join(sp, "*.libs", "libmpg123*")))
            cands += sorted(glob.glob(os.path.join(sp, "pygame.libs", "libmpg123*")))
    return cands


def _load() -> ctypes.CDLL | None:
    global _lib, _load_error
    with _lock:
        if _lib is not None:
            return _lib
        if _load_error is not None:
            return None
        errs = []
        for cand in _candidate_paths():
            try:
                lib = ctypes.CDLL(cand)
                lib.mpg123_new.restype = ctypes.c_void_p
                lib.mpg123_new.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_int)]
                lib.mpg123_param.argtypes = [
                    ctypes.c_void_p, ctypes.c_int, ctypes.c_long, ctypes.c_double,
                ]
                lib.mpg123_open.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
                lib.mpg123_getformat.argtypes = [
                    ctypes.c_void_p, ctypes.POINTER(ctypes.c_long),
                    ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
                ]
                lib.mpg123_read.argtypes = [
                    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t,
                    ctypes.POINTER(ctypes.c_size_t),
                ]
                lib.mpg123_close.argtypes = [ctypes.c_void_p]
                lib.mpg123_delete.argtypes = [ctypes.c_void_p]
                try:  # absent in modern builds (init is implicit)
                    lib.mpg123_init()
                except Exception:
                    pass
                _lib = lib
                return _lib
            except OSError as e:
                errs.append(f"{cand}: {e}")
        _load_error = "; ".join(errs) or "no candidate paths"
        return None


def available() -> bool:
    return _load() is not None


def decode_mp3(path: str) -> tuple[np.ndarray, int]:
    """Decode an MP3 file -> (float32 samples (channels, n) or (n,), rate).

    EXTRA_DECODERS signature (audio/io.py:23); load_audio downmixes and
    resamples to the 16 kHz librosa contract."""
    lib = _load()
    if lib is None:
        raise RuntimeError(
            f"libmpg123 not found ({_load_error}); set WCB_MPG123_PATH to a "
            "libmpg123 shared library to enable .mp3 decode"
        )
    err = ctypes.c_int(0)
    h = lib.mpg123_new(None, ctypes.byref(err))
    if not h:
        raise RuntimeError(f"mpg123_new failed (code {err.value})")
    try:
        lib.mpg123_param(h, _MPG123_ADD_FLAGS,
                         _MPG123_FORCE_FLOAT | _MPG123_QUIET, 0.0)
        rc = lib.mpg123_open(h, path.encode())
        if rc != _MPG123_OK:
            raise RuntimeError(f"mpg123_open({path}) failed: rc={rc}")
        rate = ctypes.c_long(0)
        channels = ctypes.c_int(0)
        enc = ctypes.c_int(0)
        rc = lib.mpg123_getformat(h, ctypes.byref(rate), ctypes.byref(channels),
                                  ctypes.byref(enc))
        if rc != _MPG123_OK:
            raise RuntimeError(f"mpg123_getformat failed: rc={rc}")

        # segments split on MPG123_NEW_FORMAT: a stitched stream (44.1 kHz
        # intro + 48 kHz body) must not be interpreted at one rate — each
        # segment is converted with ITS format and resampled to the first
        segments: list[tuple[list[bytes], int, int]] = [([], int(rate.value),
                                                         int(channels.value))]
        buf = ctypes.create_string_buffer(1 << 18)
        done = ctypes.c_size_t(0)
        while True:
            rc = lib.mpg123_read(h, buf, len(buf), ctypes.byref(done))
            if rc == _MPG123_NEW_FORMAT:
                lib.mpg123_getformat(h, ctypes.byref(rate),
                                     ctypes.byref(channels), ctypes.byref(enc))
                segments.append(([], int(rate.value), int(channels.value)))
            if done.value:
                segments[-1][0].append(buf.raw[: done.value])
            if rc == _MPG123_DONE:
                break
            if rc not in (_MPG123_OK, _MPG123_NEW_FORMAT):
                raise RuntimeError(f"mpg123_read failed: rc={rc}")

        base_rate = segments[0][1]
        parts: list[np.ndarray] = []
        for raw, seg_rate, seg_ch in segments:
            if not raw:
                continue
            seg = np.frombuffer(b"".join(raw), dtype=np.float32)
            if seg_ch > 1:
                seg = seg.reshape(-1, seg_ch).mean(axis=1)  # downmix per segment
            if seg_rate != base_rate:
                from .io import resample

                seg = resample(seg, seg_rate, base_rate)
            parts.append(seg.astype(np.float32))
        if not parts:
            return np.zeros(0, np.float32), base_rate
        return np.concatenate(parts), base_rate
    finally:
        lib.mpg123_close(h)
        lib.mpg123_delete(h)
