"""Port parity: ``.mp3`` ingestion (``audio/mp3.py``, the corpus format,
SURVEY.md §2.2). Fixtures are encoded on the fly with libmp3lame and decoded
by both packages through libmpg123: ``decode_mp3``, ``load_audio`` (mono
downmix, polyphase resample to 16 kHz) and ``PromptWhisperDataset`` items
must be equal to the JAX package's."""

import ctypes
import ctypes.util
import json

import numpy as np
import pytest

from whisper_context_biasing_tpu.audio import load_audio as jax_load_audio
from whisper_context_biasing_tpu.audio.mp3 import decode_mp3 as jax_decode_mp3
from whisper_context_biasing_tpu.data import PromptWhisperDataset as JaxDataset
from whisper_context_biasing_tpu_torch.audio import EXTRA_DECODERS, load_audio
from whisper_context_biasing_tpu_torch.audio.mp3 import available, decode_mp3
from whisper_context_biasing_tpu_torch.data import PromptWhisperDataset
from whisper_context_biasing_tpu_torch.tokenizer import load_tokenizer


def _find_lame():
    cands = []
    found = ctypes.util.find_library("mp3lame")
    if found:
        cands.append(found)
    cands += ["libmp3lame.so.0", "libmp3lame.so",
              "/usr/lib/x86_64-linux-gnu/libmp3lame.so.0"]
    for c in cands:
        try:
            return ctypes.CDLL(c)
        except OSError:
            continue
    return None


_LAME = _find_lame()

# the guard of tests/test_mp3.py
pytestmark = pytest.mark.skipif(
    _LAME is None or not available(),
    reason="libmp3lame / libmpg123 not available for MP3 fixtures",
)


def lame_encode(path: str, sig: np.ndarray, sr: int, stereo: bool = False):
    """Encode float32 [-1,1] (n,) or (2, n) to an MP3 file at 96 kbit/s."""
    lame = _LAME
    lame.lame_init.restype = ctypes.c_void_p
    h = ctypes.c_void_p(lame.lame_init())
    lame.lame_set_in_samplerate(h, sr)
    lame.lame_set_num_channels(h, 2 if stereo else 1)
    lame.lame_set_mode(h, 0 if stereo else 3)  # 0=stereo, 3=mono
    lame.lame_set_brate(h, 96)
    assert lame.lame_init_params(h) >= 0
    left = (sig[0] if stereo else sig) * 32767
    right = (sig[1] if stereo else sig) * 32767
    left, right = left.astype(np.int16), right.astype(np.int16)
    n = left.shape[0]
    out = ctypes.create_string_buffer(n * 5 // 4 + 7200)
    ln = lame.lame_encode_buffer(h, left.ctypes.data_as(ctypes.c_void_p),
                                 right.ctypes.data_as(ctypes.c_void_p), n, out, len(out))
    assert ln >= 0
    data = out.raw[:ln]
    ln = lame.lame_encode_flush(h, out, len(out))
    data += out.raw[:ln]
    lame.lame_close(h)
    with open(path, "wb") as f:
        f.write(data)


def _tone(sr, f0=440.0, seconds=1.0, stereo=False):
    t = np.arange(int(sr * seconds)) / sr
    sig = (0.6 * np.sin(2 * np.pi * f0 * t)).astype(np.float32)
    return np.stack([sig, 0.5 * sig]) if stereo else sig


@pytest.mark.parametrize("sr,stereo", [(16000, False), (24000, False), (44100, False),
                                       (32000, True)])
def test_decode_and_load_match_jax(tmp_path, sr, stereo):
    path = str(tmp_path / "clip.mp3")
    lame_encode(path, _tone(sr, stereo=stereo), sr, stereo=stereo)
    got, rate = decode_mp3(path)
    want, want_rate = jax_decode_mp3(path)
    assert rate == want_rate == sr
    np.testing.assert_array_equal(got, want)
    out = load_audio(path)
    np.testing.assert_array_equal(out, jax_load_audio(path, sample_rate=16000))
    assert out.dtype == np.float32 and out.ndim == 1
    assert abs(len(out) - 16000) < 4000  # ~1 s survives the codec's delay


def test_mp3_is_registered():
    assert EXTRA_DECODERS[".mp3"] is decode_mp3


def test_dataset_items_match_jax(tmp_path):
    """A jsonl row pointing at an .mp3 (the reference corpus schema) gives
    the JAX dataset's mel features and labels."""
    audio = tmp_path / "audio" / "test"
    audio.mkdir(parents=True)
    rows = []
    for i, (sr, f0) in enumerate(((24000, 500.0), (16000, 300.0))):
        lame_encode(str(audio / f"u{i}.mp3"), _tone(sr, f0, seconds=1.5), sr)
        rows.append({"id": str(i), "file": f"u{i}.mp3", "text": f"tone {i} hertz",
                     "description": "a tone", "bias_words": ["hertz"]})
    (tmp_path / "jsonl").mkdir()
    (tmp_path / "jsonl" / "test.jsonl").write_text("".join(json.dumps(r) + "\n" for r in rows))
    tok = load_tokenizer()
    kw = dict(base_path=str(tmp_path / "audio"), jsonl_data=str(tmp_path / "jsonl"),
              phase="test", tokenizer=tok, prompt=True, bias_list=True)
    port, ref = PromptWhisperDataset(**kw), JaxDataset(**kw)
    for i in range(len(rows)):
        got, want = port[i], ref[i]
        assert got.keys() == want.keys()
        assert got["input_features"].shape == (80, 3000)
        for k in want:
            np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)
