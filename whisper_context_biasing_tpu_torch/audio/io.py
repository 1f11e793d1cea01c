"""Host-side audio loading.

The same contract as the JAX package's ``audio/io.py``: decode -> mono
downmix (channel mean) -> resample to 16 kHz -> float32 in [-1, 1]. WAV is
parsed with the standard library and resampled by polyphase filtering
(scipy), or by the native C++ runtime (``audio/native.py``) with
``prefer_native``. Compressed formats go through ``EXTRA_DECODERS``:
``audio/mp3.py`` registers the corpus's ``.mp3`` (libmpg123 binding) at
package import.
"""

from __future__ import annotations

import os
import wave
from typing import Callable

import numpy as np

# Optional decoders for non-WAV containers, keyed by lowercase extension.
# Signature: path -> (float32 samples (channels, n) or (n,), sample_rate).
EXTRA_DECODERS: dict[str, Callable[[str], tuple[np.ndarray, int]]] = {}


def pcm_to_float32(audio: np.ndarray) -> np.ndarray:
    """Normalize raw int16 PCM to the float32 [-1, 1] ingest contract
    (i16/32768). Float input passes through as float32."""
    audio = np.asarray(audio)
    if audio.dtype == np.int16:
        return audio.astype(np.float32) / 32768.0
    return np.asarray(audio, np.float32)


def _load_wav(path: str) -> tuple[np.ndarray, int]:
    with wave.open(path, "rb") as w:
        sr = w.getframerate()
        n_channels = w.getnchannels()
        sampwidth = w.getsampwidth()
        raw = w.readframes(w.getnframes())
    if sampwidth == 2:
        data = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    elif sampwidth == 4:
        data = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
    elif sampwidth == 1:
        data = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
    else:
        raise ValueError(f"unsupported WAV sample width: {sampwidth} bytes ({path})")
    if n_channels > 1:
        data = data.reshape(-1, n_channels).T  # (channels, n)
    return data, sr


def resample(audio: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    if orig_sr == target_sr:
        return audio
    from math import gcd

    from scipy.signal import resample_poly  # seconds to import: only when resampling

    g = gcd(orig_sr, target_sr)
    return resample_poly(audio, target_sr // g, orig_sr // g, axis=-1).astype(np.float32)


def load_audio(path: str, sample_rate: int = 16000, prefer_native: bool = False,
               keep_int16: bool = False) -> np.ndarray:
    """Load a WAV file, or a format with a decoder in ``EXTRA_DECODERS``
    (``.mp3``), -> mono float32 at ``sample_rate`` (stereo is downmixed by
    channel mean). ``prefer_native``: WAV goes through the C++ runtime
    (``audio/native.py``) when it is available. ``keep_int16``: a mono
    16-bit WAV already at ``sample_rate`` comes back as its raw int16
    samples (the chunked decoder normalizes on the device, so half the bytes
    cross to it); any other file keeps the float32 contract."""
    ext = os.path.splitext(path)[1].lower()
    if keep_int16 and ext in (".wav", ".wave"):
        with wave.open(path, "rb") as w:
            if (w.getsampwidth() == 2 and w.getnchannels() == 1
                    and w.getframerate() == sample_rate):
                return np.frombuffer(w.readframes(w.getnframes()), dtype="<i2")
    if prefer_native and ext in (".wav", ".wave"):
        from . import native

        if native.available():
            try:
                return native.decode_audio(path, sample_rate)
            except RuntimeError as e:
                # e.g. WAVE_FORMAT_EXTENSIBLE or audio over the buffer: the
                # standard-library path below takes both
                print(f"[native] decode failed ({e}); using Python decoder")
    if ext in EXTRA_DECODERS:
        data, sr = EXTRA_DECODERS[ext](path)
    elif ext in (".wav", ".wave"):
        data, sr = _load_wav(path)
    else:
        raise ValueError(
            f"no decoder for '{ext}' files ({path}); register one in "
            "whisper_context_biasing_tpu_torch.audio.io.EXTRA_DECODERS"
        )
    data = np.asarray(data, dtype=np.float32)
    if data.ndim > 1:
        data = data.mean(axis=0)
    return resample(data, sr, sample_rate)
