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
    """Sequential and chunked long-form and long-form word timestamps are
    ported (tests/test_torch_long_form.py, test_torch_chunked.py,
    test_torch_word_timestamps.py), and so are a draft and Medusa heads on a
    long clip (the t=0 rung): the plain tokens, and a stream too."""
    from whisper_context_biasing_tpu_torch.models import init_medusa_params

    _, port = _tiny_pipelines()
    clip = np.zeros(port.window_samples + 16000, np.float32)
    for kw in (dict(long_form="chunked"), dict(long_form="auto", word_timestamps=True)):
        res = port.transcribe(clip, max_tokens=4, temperatures=(0.0,), **kw)
        assert res.segments is not None
    cfg = port.cfg
    for accel in (dict(draft_model="tiny.en", draft_config=cfg), dict(
            medusa=init_medusa_params(cfg, 2))):
        fast = Pipeline("tiny.en", config=cfg, device="cpu", **accel)
        fast.model = port.model  # the same weights as the plain pipeline
        if fast.draft is not None:
            fast.draft = port.model
        for kw in (dict(long_form="chunked"), dict(long_form="auto")):
            got = fast.transcribe(clip, max_tokens=4, temperatures=(0.0,), **kw)
            assert got.tokens == port.transcribe(clip, max_tokens=4, temperatures=(0.0,),
                                                 **kw).tokens
        # the timestamp rules stay off with an accelerator (as in JAX)
        st = fast.stream(max_new=4, temperatures=(0.0,), use_timestamps=False)
        st.feed(clip)
        st.finish()
        plain = port.stream(max_new=4, temperatures=(0.0,), use_timestamps=False)
        plain.feed(clip)
        plain.finish()
        assert st.tokens == plain.tokens


# ---------------------------------------------------------------------------
# window_buckets
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def bucket_pipelines():
    """The JAX and the port's Pipeline with the real 30 s window."""
    jcfg = jax_tiny(n_audio_ctx=1500, quantize_cross_kv=True, gelu_approx=True)
    params = jax.tree.map(np.asarray, jax_init(jcfg, 0))
    ref = JaxPipeline("tiny.en", config=jcfg, params=params, model_parallelism=0)
    port = Pipeline("tiny.en", config=tiny_test_config(n_audio_ctx=1500, **FAST_OVERRIDES),
                    params=params, device="cpu")
    return ref, port


@pytest.mark.parametrize("words", [False, True], ids=["tokens", "words"])
def test_window_buckets_match_jax(bucket_pipelines, words):
    """window_buckets=(8, 15) on clips of 5, 12, 6 and 20 s: each bucket's
    tokens (and word timings) identical to the JAX Pipeline's bucketed
    call; buckets of 2, 1 and 1 clips decode as batches of 8 whose padding
    rows are dropped."""
    ref, port = bucket_pipelines
    rng = np.random.default_rng(7)
    clips = [(0.1 * rng.standard_normal(int(s * 16000))).astype(np.float32)
             for s in (5.0, 12.0, 6.0, 20.0)]
    kw = dict(window_buckets=(8, 15), max_tokens=5, context="patient on aspirin",
              bias_words=["aspirin"], bias_boost=2.0, word_timestamps=words)
    want, got = ref.transcribe(clips, **kw), port.transcribe(clips, **kw)
    assert len(got) == 4 and [r.tokens for r in got] == [r.tokens for r in want]
    if words:
        assert [[(w.word, w.start, w.end, w.probability) for w in r.words] for r in got] \
            == [[(w.word, w.start, w.end, w.probability) for w in r.words] for r in want]
        assert [r.segments for r in got] == [r.segments for r in want]
    buckets = port.last_timings["buckets"]
    assert {s: (b["clips"], b["rows"]) for s, b in buckets.items()} \
        == {128000: (2, 8), 240000: (1, 8), 480000: (1, 8)}


def test_window_buckets_long_form_warns_and_bad_sizes_raise(bucket_pipelines):
    ref, port = bucket_pipelines
    long_clip = np.zeros(port.window_samples + 16000, np.float32)
    for pipe in (port, ref):
        with pytest.warns(UserWarning, match="window_buckets applies to the short-form"):
            pipe.transcribe(long_clip, window_buckets=(8,), max_tokens=2, temperatures=(0.0,))
        with pytest.raises(ValueError, match="positive seconds"):
            pipe.transcribe(np.zeros(1600, np.float32), window_buckets=(0,), max_tokens=2)


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


def test_pipeline_draft_and_medusa_match_jax(tmp_path):
    """``Pipeline(draft_model=..., draft_params=...)`` (a draft with the
    target's mel, and one with 128 mels that gets its own mel on the
    short-form route and a warning with plain decoding on the long-form one)
    and ``Pipeline(medusa="medusa.npz")``: the JAX Pipeline's tokens, which
    are the plain pipeline's."""
    from whisper_context_biasing_tpu_torch.models import init_medusa_params, save_medusa

    ref, port = _tiny_pipelines()
    jcfg = ref.cfg
    rng = np.random.default_rng(1)
    clips = [(0.1 * rng.standard_normal(n)).astype(np.float32) for n in (8000, 16000)]
    kw = dict(context="patient on aspirin", bias_words=["aspirin"], bias_boost=2.0,
              max_tokens=8)
    plain = [r.tokens for r in port.transcribe(clips, **kw)]
    heads = str(tmp_path / "medusa.npz")
    save_medusa(heads, init_medusa_params(port.cfg, 2, 0))
    dcfg = dict(n_audio_layers=1, n_text_layers=1, d_model=32, n_heads=2)
    for name, mels in (("same mel", 80), ("own mel", 128)):
        jd = jax_tiny(n_mels=mels, **dcfg)
        dparams = jax.tree.map(np.asarray, jax_init(jd, 3))
        d = tiny_test_config(n_mels=mels, **dcfg)
        both = [P("tiny.en", config=c, params=ref.params, draft_model="tiny.en", draft_config=dc,
                  draft_params=dparams, speculative_k=3, **extra)
                for P, c, dc, extra in ((JaxPipeline, jcfg, jd, dict(model_parallelism=0)),
                                        (Pipeline, port.cfg, d, dict(device="cpu")))]
        want, got = (p.transcribe(clips, **kw) for p in both)
        assert [r.tokens for r in got] == [r.tokens for r in want] == plain, name
    with pytest.warns(UserWarning, match="n_mels"):
        long = both[1].transcribe(np.zeros(port.window_samples + 8000, np.float32),
                                  max_tokens=4, temperatures=(0.0,))
    assert long.tokens == port.transcribe(np.zeros(port.window_samples + 8000, np.float32),
                                          max_tokens=4, temperatures=(0.0,)).tokens
    pipes = [JaxPipeline("tiny.en", config=jcfg, params=ref.params, model_parallelism=0,
                         medusa=heads, medusa_chains=2),
             Pipeline("tiny.en", config=port.cfg, params=ref.params, device="cpu", medusa=heads,
                      medusa_chains=2)]
    want, got = (p.transcribe(clips, **kw) for p in pipes)
    assert pipes[1].medusa["n_chains"] == 2
    assert [r.tokens for r in got] == [r.tokens for r in want] == plain
