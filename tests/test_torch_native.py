"""Port parity for the native (C++) host audio runtime (``audio/native.py``,
built from ``native/wcb_native.cpp`` at first use) and the two
``load_audio`` options that use it: WAV decode against the port's Python
decoder and the JAX package's native decode (mono, stereo, resampled,
WAVE_FORMAT_EXTENSIBLE), the threaded batch loader, the error paths, the
fallback to the Python decoder past the native buffer, and ``keep_int16``.
"""

import shutil
import struct
import wave

import numpy as np
import pytest

from whisper_context_biasing_tpu.audio import load_audio as jax_load_audio
from whisper_context_biasing_tpu.audio import native as jax_native
from whisper_context_biasing_tpu_torch.audio import load_audio, native

pytestmark = pytest.mark.skipif(shutil.which("g++") is None, reason="no C++ toolchain")


@pytest.fixture(scope="module", autouse=True)
def lib():
    lib = native.load_library()
    if lib is None:
        pytest.skip("native library failed to build")
    return lib


def write_wav(path, sig_i16, sr=16000, channels=1):
    with wave.open(str(path), "wb") as w:
        w.setnchannels(channels)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(sig_i16.tobytes())


def tone(n, sr=16000, f=440.0, amp=0.4, seed=None):
    t = np.arange(n) / sr
    sig = amp * np.sin(2 * np.pi * f * t)
    if seed is not None:
        sig += 0.01 * np.random.default_rng(seed).standard_normal(n)
    return sig.astype(np.float32)


def stereo(n):
    inter = np.empty(2 * n, np.int16)
    inter[0::2] = (tone(n, f=300) * 16384).astype(np.int16)
    inter[1::2] = (tone(n, f=700) * 16384).astype(np.int16)
    return inter


@pytest.mark.parametrize("case", ["mono", "stereo", "resample_32k", "resample_8k"])
def test_native_decode_matches_python_and_jax(tmp_path, case):
    path = tmp_path / f"{case}.wav"
    if case == "mono":
        write_wav(path, (tone(16000, seed=0) * 32767).astype(np.int16))
    elif case == "stereo":
        write_wav(path, stereo(8000), channels=2)
    else:
        sr = 32000 if case == "resample_32k" else 8000
        write_wav(path, (tone(sr, sr=sr, f=1000) * 32767).astype(np.int16), sr=sr)
    got = native.decode_audio(str(path))
    np.testing.assert_array_equal(got, jax_native.decode_audio(str(path)))
    np.testing.assert_array_equal(load_audio(str(path), prefer_native=True), got)
    ref = load_audio(str(path))  # the Python decoder (scipy's polyphase resampler)
    np.testing.assert_array_equal(ref, jax_load_audio(str(path)))
    if case in ("mono", "stereo"):
        np.testing.assert_allclose(got, ref, atol=1e-6)
    else:  # a windowed-sinc resampler against the polyphase one, edges left out
        n = min(len(got), len(ref))
        a, b = got[200: n - 200], ref[200: n - 200]
        assert np.sqrt(np.mean((a - b) ** 2)) / np.sqrt(np.mean(b ** 2)) < 0.005


def test_batch_decode_matches_jax(tmp_path):
    paths = []
    for i, n in enumerate([8000, 16000, 24000]):
        paths.append(str(tmp_path / f"b{i}.wav"))
        write_wav(paths[-1], (tone(n, f=200 * (i + 1)) * 32767).astype(np.int16))
    out = native.decode_batch(paths, fixed_len=16000, num_threads=3)
    np.testing.assert_array_equal(out, jax_native.decode_batch(paths, fixed_len=16000,
                                                               num_threads=3))
    assert out.shape == (3, 16000) and np.all(out[0, 8000:] == 0)
    np.testing.assert_allclose(out[2], load_audio(paths[2])[:16000], atol=1e-6)
    with pytest.raises(RuntimeError, match="missing.wav"):
        native.decode_batch([paths[0], str(tmp_path / "missing.wav")], fixed_len=4000)


def test_errors_extensible_and_fallback(tmp_path):
    with pytest.raises(RuntimeError, match="cannot read file"):
        native.decode_audio("/nonexistent/x.wav")
    bad = tmp_path / "bad.wav"
    bad.write_bytes(b"not a wav at all, definitely not 44 bytes of RIFF")
    with pytest.raises(RuntimeError, match="RIFF"):
        native.decode_audio(str(bad))
    # WAVE_FORMAT_EXTENSIBLE (tag 0xFFFE) around plain PCM16
    sr, n = 16000, 1600
    pcm = (np.sin(2 * np.pi * 440 * np.arange(n) / sr) * 20000).astype("<i2")
    guid = b"\x01\x00\x00\x00\x00\x00\x10\x00\x80\x00\x00\xaa\x00\x38\x9b\x71"
    fmt = struct.pack("<HHIIHHHHI", 0xFFFE, 1, sr, sr * 2, 2, 16, 22, 16, 0x1) + guid
    riff = (b"WAVE" + b"fmt " + struct.pack("<I", len(fmt)) + fmt + b"data"
            + struct.pack("<I", len(pcm) * 2) + pcm.tobytes())
    ext = tmp_path / "ext.wav"
    ext.write_bytes(b"RIFF" + struct.pack("<I", len(riff)) + riff)
    sig = native.decode_audio(str(ext), sr)
    np.testing.assert_array_equal(sig, jax_native.decode_audio(str(ext), sr))
    np.testing.assert_allclose(sig, pcm.astype(np.float32) / 32768.0, atol=1e-4)
    # past the buffer: the native call raises, load_audio takes the Python path
    long = tmp_path / "long.wav"
    write_wav(long, np.ones(16000 * 4, np.int16))
    with pytest.raises(RuntimeError, match="capacity"):
        native.decode_audio(str(long), 16000, max_len=16000)
    assert len(load_audio(str(long), prefer_native=True)) == 16000 * 4


def test_keep_int16_matches_jax(tmp_path):
    """``keep_int16`` returns the raw samples of a mono 16-bit WAV at the
    target rate; a stereo or resampled file keeps the float32 contract."""
    pcm = (np.arange(1600) % 700 - 350).astype(np.int16)
    mono, two, slow = tmp_path / "m.wav", tmp_path / "s.wav", tmp_path / "r.wav"
    write_wav(mono, pcm)
    write_wav(two, stereo(800), channels=2)
    write_wav(slow, pcm, sr=8000)
    for path in (mono, two, slow):
        got = load_audio(str(path), keep_int16=True)
        want = jax_load_audio(str(path), keep_int16=True)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(load_audio(str(mono), keep_int16=True), pcm)
    assert load_audio(str(two), keep_int16=True).dtype == np.float32
