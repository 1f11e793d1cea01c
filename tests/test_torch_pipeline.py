"""Port parity end to end: the port's Pipeline against the JAX package's on
synthetic clips with a context and bias words: identical tokens and text.

Both get the same tiny config with int8 cross-K/V and the serving path's tanh
gelu. The JAX side runs its XLA paths (its Pallas kernels compile for a TPU
only) with no device mesh; the port runs every kernel switch on, i.e. their
plain versions on the CPU."""

import wave

import jax
import numpy as np
import pytest

from whisper_context_biasing_tpu import Pipeline as JaxPipeline
from whisper_context_biasing_tpu.audio import load_audio as jax_load_audio
from whisper_context_biasing_tpu.models import init_params as jax_init
from whisper_context_biasing_tpu.models import tiny_test_config as jax_tiny
from whisper_context_biasing_tpu_torch import Pipeline
from whisper_context_biasing_tpu_torch.audio import load_audio
from whisper_context_biasing_tpu_torch.models import FAST_OVERRIDES, tiny_test_config


def test_pipeline_matches_jax():
    jcfg = jax_tiny(quantize_cross_kv=True, gelu_approx=True)
    params = jax.tree.map(np.asarray, jax_init(jcfg, 0))
    rng = np.random.default_rng(0)
    # 0.4 s, 1.0 s and a full window (64 encoder states = 20480 samples)
    clips = [(0.1 * rng.standard_normal(n)).astype(np.float32) for n in (6400, 16000, 20480)]
    kw = dict(context="patient on aspirin and metformin", bias_words=["aspirin", "metformin"],
              bias_boost=2.0, max_tokens=12)

    ref = JaxPipeline("tiny.en", config=jcfg, params=params, model_parallelism=0)
    port = Pipeline("tiny.en", config=tiny_test_config(**FAST_OVERRIDES), params=params,
                    device="cpu")
    want, got = ref.transcribe(clips, **kw), port.transcribe(clips, **kw)
    assert [r.tokens for r in got] == [r.tokens for r in want]
    assert [r.text for r in got] == [r.text for r in want]
    assert all(r.tokens for r in got)
    assert set(port.last_timings) == {"mel_ms", "encode_ms", "prefill_ms", "decode_ms", "steps"}


def _tiny_pipelines():
    jcfg = jax_tiny(quantize_cross_kv=True, gelu_approx=True)
    params = jax.tree.map(np.asarray, jax_init(jcfg, 0))
    ref = JaxPipeline("tiny.en", config=jcfg, params=params, model_parallelism=0)
    port = Pipeline("tiny.en", config=tiny_test_config(**FAST_OVERRIDES), params=params,
                    device="cpu")
    return ref, port


def test_pipeline_trims_a_long_clip_short_form_as_jax():
    """long_form=False: a clip one second over the window is trimmed to the
    window and decoded short-form, as the JAX Pipeline does."""
    ref, port = _tiny_pipelines()
    rng = np.random.default_rng(5)
    clip = (0.1 * rng.standard_normal(port.window_samples + 16000)).astype(np.float32)
    kw = dict(context="patient on aspirin", bias_words=["aspirin"], bias_boost=2.0,
              max_tokens=12, long_form=False)
    want, got = ref.transcribe(clip, **kw), port.transcribe(clip, **kw)
    assert got.tokens == want.tokens and got.tokens
    assert got.text == want.text


def test_pipeline_long_clip_auto_is_not_ported():
    """Sequential long-form is ported (tests/test_torch_long_form.py); the
    chunked mode and long-form word timestamps are not."""
    _, port = _tiny_pipelines()
    clip = np.zeros(port.window_samples + 16000, np.float32)
    for kw in (dict(long_form="chunked"), dict(long_form="auto", word_timestamps=True)):
        with pytest.raises(NotImplementedError, match="Queue A.6"):
            port.transcribe(clip, max_tokens=4, **kw)


def test_load_audio_matches_jax(tmp_path):
    """Stereo 8 kHz int16 WAV: downmix and resample to 16 kHz as in JAX."""
    rng = np.random.default_rng(1)
    pcm = (rng.standard_normal((4000, 2)) * 3000).astype("<i2")
    path = str(tmp_path / "clip.wav")
    with wave.open(path, "wb") as w:
        w.setnchannels(2)
        w.setsampwidth(2)
        w.setframerate(8000)
        w.writeframes(pcm.tobytes())
    got = load_audio(path)
    assert got.dtype == np.float32 and got.shape == (8000,)
    np.testing.assert_array_equal(got, jax_load_audio(path))
