"""Port parity for streaming sessions (``decode/streaming.py``): audio fed
in 0.5 s, 7 s and 31 s chunks gives the tokens and segments of the port's
``transcribe_long_batch`` on the whole audio and of the JAX package's
``StreamingTranscriber`` fed the same way, through one scripted
``decode_fn`` (the JAX package's tests/test_streaming.py cases: timestamp
seeking that decodes a window's open tail again, the no-timestamp mode, a
partial window waiting, history prompts, an empty stream, the silence
rule); then the real decode with word timestamps against both, and
``Pipeline.stream`` against the JAX Pipeline's. Tokens, segments and words
identical."""

import jax
import numpy as np
import pytest

from whisper_context_biasing_tpu import Pipeline as JaxPipeline
from whisper_context_biasing_tpu.audio.mel import log_mel_spectrogram_np
from whisper_context_biasing_tpu.decode import StreamingTranscriber as JaxStreamingTranscriber
from whisper_context_biasing_tpu.decode.greedy import GreedyResult as JaxGreedyResult
from whisper_context_biasing_tpu.models import init_params as jax_init
from whisper_context_biasing_tpu.models import tiny_test_config as jax_tiny
from whisper_context_biasing_tpu_torch import Pipeline
from whisper_context_biasing_tpu_torch.decode import StreamingTranscriber, transcribe_long_batch
from whisper_context_biasing_tpu_torch.decode.greedy import GreedyResult
from whisper_context_biasing_tpu_torch.models import (
    FAST_OVERRIDES,
    build_model,
    params_from_jax,
    tiny_test_config,
)
from whisper_context_biasing_tpu_torch.tokenizer import load_tokenizer

SR = 16000


@pytest.fixture(scope="module")
def tok():
    return load_tokenizer()


def mel_fn(chunk):
    """A 'mel' that carries the window's first sample, so that the scripted
    decode tells windows apart."""
    chunk = np.asarray(chunk)
    m = np.zeros((chunk.shape[0], 80, 3000), np.float32)
    m[:, 0, 0] = chunk[:, 0]
    return m


def scripted(tok, cls, *, timestamps=True, seg_end_s=20.0, slp=0.0, nsp=0.0, log=None):
    """With timestamps: one closed segment [0, seg_end_s] whose content token
    depends on the window (so seeking advances seg_end_s and the open tail
    decodes again); without: one word. Logs each call's prefix length."""
    word = tok.encode(" hello" if timestamps else " hi", add_special_tokens=False)
    ts_end = tok.timestamp_begin + int(seg_end_s / 0.02)

    def decode_fn(mel, ids, mask, temperature, _):
        if log is not None:
            log.append(int(np.asarray(mask).sum()))
        b = mel.shape[0]
        marker = (np.abs(np.asarray(mel)[:, 0, 0]) * 100).astype(np.int32) % 50
        if timestamps:
            rows = np.stack([np.asarray([tok.timestamp_begin] + [w + int(marker[i]) for w in word]
                                        + [ts_end, tok.eot], np.int32) for i in range(b)])
        else:
            rows = np.tile(np.asarray(word + [tok.eot], np.int32), (b, 1))
        return cls(rows, np.full((b,), rows.shape[1] - 1, np.int32),
                   np.full((b,), slp, np.float32), np.full((b,), nsp, np.float32))
    return decode_fn


def make_audio(seconds):
    """Each sample holds (second index + 1) / 100: windows start differently."""
    return ((np.arange(int(seconds * SR)) // SR + 1) / 100.0).astype(np.float32)


def feed_all(st, audio, chunk_s):
    step = int(chunk_s * SR)
    segs = []
    for i in range(0, len(audio), step):
        segs.extend(st.feed(audio[i: i + step]))
    return segs + st.finish()


def both_streams(tok, kw, **script):
    """(port session, JAX session), each with its own scripted decode_fn
    and call log."""
    logs = [], []
    port = StreamingTranscriber(None, tok, mel_fn=mel_fn, device="cpu",
                                decode_fn=scripted(tok, GreedyResult, log=logs[0], **script),
                                **kw)
    ref = JaxStreamingTranscriber(None, jax_tiny(), tok, mel_fn=mel_fn,
                                  decode_fn=scripted(tok, JaxGreedyResult, log=logs[1], **script),
                                  **kw)
    return port, ref, logs


@pytest.mark.parametrize("chunk_s", [0.5, 7.0, 31.0])
@pytest.mark.parametrize("timestamps", [True, False], ids=["timestamps", "text"])
def test_stream_matches_batch_loop_and_jax(tok, chunk_s, timestamps):
    audio = make_audio(75 if timestamps else 40)
    kw = dict(use_timestamps=timestamps, temperatures=(0.0,), no_speech_threshold=0.6,
              logprob_threshold=-1.0)
    ref_tokens, ref_segs = transcribe_long_batch(
        None, tok, [audio], decode_fn=scripted(tok, GreedyResult, timestamps=timestamps),
        return_segments=True, mel_fn=mel_fn, device="cpu", **kw)
    port, jax_st, logs = both_streams(tok, kw, timestamps=timestamps)
    segs = feed_all(port, audio, chunk_s)
    jax_segs = feed_all(jax_st, audio, chunk_s)
    assert port.tokens == ref_tokens[0] == jax_st.tokens
    assert segs == port.segments == ref_segs[0] == jax_segs
    assert port.window_info == jax_st.window_info and logs[0] == logs[1]
    assert len(port.window_info) >= 2


@pytest.mark.parametrize("case", ["waits", "history", "empty", "silence"])
def test_incremental_behaviour_matches_jax(tok, case):
    kw = dict(temperatures=(0.0,))
    script = {}
    if case in ("history", "silence"):
        kw["use_timestamps"] = False
        script["timestamps"] = False
    if case == "silence":
        kw.update(temperatures=(0.0, 0.5), no_speech_threshold=0.6, logprob_threshold=-1.0)
        script.update(slp=-50.0, nsp=0.95)
    port, ref, logs = both_streams(tok, kw, **script)
    outs = []
    for st in (port, ref):
        if case == "waits":
            outs.append((st.feed(make_audio(10)), st.buffered_samples, st.feed(make_audio(25))))
        elif case == "history":
            st.feed(make_audio(65))
            st.finish()
        elif case == "silence":
            st.feed(make_audio(31))
            st.finish()
        else:
            st.finish()
        outs.append((st.tokens, st.segments, st.window_info))
    assert outs[: len(outs) // 2] == outs[len(outs) // 2:]
    assert logs[0] == logs[1]
    if case == "waits":
        assert outs[0][0] == [] and outs[0][1] == 10 * SR and outs[0][2]
    if case == "history":
        assert logs[0][1] > logs[0][0]  # the second window's prefix holds the history
    if case == "empty":
        assert len(logs[0]) == 1
    if case == "silence":
        assert port.tokens == []
    with pytest.raises(RuntimeError, match="finished"):
        port.finish()
        port.feed(np.zeros(100, np.float32))


@pytest.fixture(scope="module")
def real(tok):
    cfg_kw = dict(n_audio_ctx=1500, quantize_cross_kv=True)
    jcfg = jax_tiny(**cfg_kw)
    params = jax.tree.map(np.asarray, jax_init(jcfg, 0))
    cfg = tiny_test_config(**cfg_kw, flash_attention=True, fused_quant_cross=True)
    return jcfg, params, build_model(cfg, params_from_jax(params, cfg), device="cpu")


def numpy_mel(chunk):
    return np.stack([log_mel_spectrogram_np(x) for x in np.asarray(chunk)])


def test_real_stream_with_words_matches_batch_and_jax(tok, real):
    """The tiny model's own decode, timestamps and word timestamps, a 45 s
    stream fed in 7 s chunks."""
    jcfg, params, model = real
    rng = np.random.default_rng(0)
    audio = (rng.standard_normal(45 * SR) * 0.1).astype(np.float32)
    kw = dict(mel_fn=numpy_mel, max_new=6, use_timestamps=True, temperatures=(0.0,),
              no_speech_threshold=None, word_timestamps=True)
    out = transcribe_long_batch(model, tok, [audio], return_segments=True, device="cpu",
                                prefix_pad_to_multiple=32, **kw)
    port = StreamingTranscriber(model, tok, device="cpu", **kw)
    ref = JaxStreamingTranscriber(params, jcfg, tok, **kw)
    for st in (port, ref):
        feed_all(st, audio, 7.0)
    assert port.tokens == out[0][0] == ref.tokens
    assert port.segments == out[1][0] == ref.segments
    as_tuples = [(w.word, w.start, w.end, w.tokens, w.probability) for w in port.words]
    assert as_tuples == [(w.word, w.start, w.end, w.tokens, w.probability) for w in out[2][0]]
    assert as_tuples == [(w.word, w.start, w.end, w.tokens, w.probability) for w in ref.words]
    assert port.words and port.words[-1].end <= 45.0


def test_pipeline_stream_matches_jax(tok):
    """``Pipeline.stream`` (the 64-state, 1.28 s window, context and bias
    words) against the JAX Pipeline's, fed 0.5 s at a time."""
    jcfg = jax_tiny(quantize_cross_kv=True, gelu_approx=True)
    params = jax.tree.map(np.asarray, jax_init(jcfg, 0))
    ref = JaxPipeline("tiny.en", config=jcfg, params=params, model_parallelism=0,
                      bias_words=["aspirin"], bias_boost=2.0)
    port = Pipeline("tiny.en", config=tiny_test_config(**FAST_OVERRIDES), params=params,
                    device="cpu", bias_words=["aspirin"], bias_boost=2.0)
    rng = np.random.default_rng(2)
    audio = (rng.standard_normal(int(4.2 * SR)) * 0.1).astype(np.float32)
    kw = dict(context="patient on aspirin", max_new=5, temperatures=(0.0,))
    sessions = [port.stream(**kw), ref.stream(**kw)]
    for st in sessions:
        feed_all(st, audio, 0.5)
    assert sessions[0].tokens == sessions[1].tokens and sessions[0].tokens
    assert sessions[0].segments == sessions[1].segments
    assert sessions[0].text == sessions[1].text
