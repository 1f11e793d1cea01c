"""Port parity for chunked (parallel-window) long-form transcription
(``decode/chunked.py``): ``chunk_layout``, ``split_token_segments`` and
``merge_longest_common_sequence`` identical to the JAX package's; the
control flow of ``transcribe_chunked`` (ownership, the batched ladder, the
silence rule, batch flattening and padding, the LCS mode, best_of) through
one scripted ``decode_fn`` given to both packages, with identical calls and
outputs; then the real decode against the JAX package's on a 70 s and a
12 s clip (timestamp and token modes, contexts, bias spans and start tokens,
the VAD gate, padded batches with word timestamps, beams at t=0, int16
input), ``Pipeline(long_form="chunked")`` against the JAX Pipeline and
``cli.transcribe --long --chunked`` against the JAX script.

The model is ``tiny_test_config`` with the real 30 s window for the decode
cases (both packages get the numpy log-mel of the same windows) and the
64-state window for the Pipeline case. Tolerances: tokens, segments, words
and window fields identical, except ``avg_logprob`` and
``no_speech_prob`` within 1e-5 (f32 sums over 51864 logits in other
orders)."""

import dataclasses
import functools
import importlib.util
import json
import os
import sys
import wave

import jax
import numpy as np
import pytest

import whisper_context_biasing_tpu.models as jax_models
from whisper_context_biasing_tpu import Pipeline as JaxPipeline
from whisper_context_biasing_tpu.audio.mel import log_mel_spectrogram_np
from whisper_context_biasing_tpu.decode import chunked as jax_chunked
from whisper_context_biasing_tpu.decode.greedy import GreedyResult as JaxGreedyResult
from whisper_context_biasing_tpu.models import init_params as jax_init
from whisper_context_biasing_tpu.models import save_safetensors as jax_save_safetensors
from whisper_context_biasing_tpu.models import tiny_test_config as jax_tiny
from whisper_context_biasing_tpu_torch import Pipeline
from whisper_context_biasing_tpu_torch.cli import transcribe
from whisper_context_biasing_tpu_torch.decode import chunked
from whisper_context_biasing_tpu_torch.decode.greedy import GreedyResult
from whisper_context_biasing_tpu_torch.models import (
    FAST_OVERRIDES,
    build_model,
    params_from_jax,
    tiny_test_config,
)
from whisper_context_biasing_tpu_torch.tokenizer import load_tokenizer

SR = 16000
WIN = 480000
CFG = dict(n_audio_ctx=1500, quantize_cross_kv=True)
KERNELS = dict(flash_attention=True, fused_quant_cross=True)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def speech_like(rng, seconds):
    t = np.arange(int(seconds * SR)) / SR
    f0 = 110 + 40 * np.sin(2 * np.pi * rng.uniform(0.2, 0.6) * t)
    phase = 2 * np.pi * np.cumsum(f0) / SR
    voiced = sum(np.sin(k * phase) / k for k in range(1, 6))
    env = 0.5 + 0.5 * np.sin(2 * np.pi * rng.uniform(3, 5) * t)
    return (0.1 * env * voiced + 0.005 * rng.standard_normal(t.size)).astype(np.float32)


def numpy_mel(chunk):
    """The numpy log-mel of each window, for both packages (the port hands
    ``mel_fn`` a CPU tensor, the JAX package an array)."""
    return np.stack([log_mel_spectrogram_np(x) for x in np.asarray(chunk)])


@pytest.fixture(scope="module")
def tok():
    return load_tokenizer()


@pytest.fixture(scope="module")
def setup(tok):
    jcfg = jax_tiny(**CFG)
    params = jax.tree.map(np.asarray, jax_init(jcfg, 0))
    cfg = tiny_test_config(**CFG, **KERNELS)
    model = build_model(cfg, params_from_jax(params, cfg), device="cpu")
    rng = np.random.default_rng(0)
    return jcfg, params, model, [speech_like(rng, 70.0), speech_like(rng, 12.0)]


def _enc(tok, text):
    return tok.encode(text, add_special_tokens=False)


def _ts(tok, seconds):
    return tok.timestamp_begin + int(round(seconds / 0.02))


# ---------------------------------------------------------------------------
# host helpers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,stride", [(1000, None), (WIN, None), (WIN + 1, None),
                                      (int(2.5 * WIN), None), (10 * WIN + 777, None),
                                      (10 * WIN, WIN // 4), (10 * WIN, WIN // 2)])
def test_chunk_layout_matches_jax(n, stride):
    if stride == WIN // 2:
        for mod in (chunked, jax_chunked):
            with pytest.raises(ValueError, match="stride too large"):
                mod.chunk_layout(n, WIN, stride)
        return
    got = chunked.chunk_layout(n, WIN, stride)
    assert got == jax_chunked.chunk_layout(n, WIN, stride)
    assert got[0][1] == 0 and got[-1][2] == max(n, 1)
    assert all(a[2] == b[1] for a, b in zip(got, got[1:]))  # the cores tile [0, n)


def test_token_segments_and_lcs_merge_match_jax(tok):
    words = _enc(tok, " hello there")
    rows = [[_ts(tok, 0.0)] + words + [_ts(tok, 2.0), _ts(tok, 2.0)] + _enc(tok, " again")
            + [_ts(tok, 4.0)],
            [_ts(tok, 1.0)] + _enc(tok, " partial"),
            [_ts(tok, 1.0), _ts(tok, 1.5)] + words + [tok.eot],
            words, []]
    for row in rows:
        assert chunked.split_token_segments(row, tok) == jax_chunked.split_token_segments(row, tok)
    seqs = [[[1, 2, 3, 4, 5, 6], [4, 5, 6, 7, 8]], [[1, 2, 3], [7, 8, 9]],
            [[1, 2, 3, 10, 5, 6], [3, 4, 5, 6, 7, 8]], [[1, 2, 3, 4], [3, 4, 5, 6], [5, 6, 7, 8]],
            [], [[], [1, 2]], [[1, 2], []]]
    rng = np.random.default_rng(1)
    seqs += [[list(rng.integers(0, 4, rng.integers(0, 12))) for _ in range(4)] for _ in range(30)]
    for s in seqs:
        assert (chunked.merge_longest_common_sequence(s)
                == jax_chunked.merge_longest_common_sequence(s))
    assert chunked.merge_longest_common_sequence(seqs[3]) == list(range(1, 9))


# ---------------------------------------------------------------------------
# transcribe_chunked's control flow through one scripted decode_fn
# ---------------------------------------------------------------------------

def _result(cls, rows, eot=50256, sum_logprob=None, width=64, no_speech=None):
    toks = np.full((len(rows), width), eot, np.int32)
    lens = np.zeros(len(rows), np.int32)
    for i, r in enumerate(rows):
        toks[i, : len(r)] = r
        lens[i] = len(r)
    slp = (np.zeros(len(rows), np.float32) if sum_logprob is None
           else np.asarray(sum_logprob, np.float32))
    nsp = None if no_speech is None else np.asarray(no_speech, np.float32)
    return cls(toks, lens, slp, nsp)


def scripted(tok, case):
    """(audios, options, decode_fn factory(result class, call log)) of one
    case of the JAX package's tests/test_chunked.py."""
    loop = _enc(tok, " the same words") * 30
    good = [_ts(tok, 0.0)] + _enc(tok, " clean text") + [_ts(tok, 2.0)]
    if case == "single_window":
        row = [_ts(tok, 0.0)] + _enc(tok, " aspirin daily") + [_ts(tok, 2.0)]
        return [np.ones(16000, np.float32)], {}, lambda cls, log: lambda m, *_: _result(
            cls, [row] * m.shape[0])
    if case == "ownership":
        n = int(1.5 * WIN)
        (s0, _, _), (s1, b0, _) = chunked.chunk_layout(n, WIN)
        t_abs = b0 / SR + 1.0
        w0, w1 = t_abs - s0 / SR, t_abs - s1 / SR
        words = _enc(tok, " overlap segment")
        early = [_ts(tok, 0.0)] + _enc(tok, " early part") + [_ts(tok, 2.0)]
        rows = [early + [_ts(tok, w0)] + words + [_ts(tok, w0 + 1.5)],
                [_ts(tok, w1)] + words + [_ts(tok, w1 + 1.5)]]
        return [np.ones(n, np.float32)], {}, lambda cls, log: lambda m, *_: _result(cls, rows)
    if case == "fallback":
        def make(cls, log):
            def fn(mel, ids, mask, temperature, _):
                log.append(temperature)
                return _result(cls, [loop if temperature == 0.0 else good], width=len(loop) + 4)
            return fn
        return [np.ones(1000, np.float32)], dict(temperatures=(0.0, 0.4)), make
    if case == "silence":
        row = [_ts(tok, 0.0)] + _enc(tok, " ghost text") + [_ts(tok, 2.0)]
        return ([np.ones(1000, np.float32)],
                dict(compression_ratio_threshold=None, logprob_threshold=-1.0,
                     no_speech_threshold=0.6),
                lambda cls, log: lambda *_: _result(cls, [row], sum_logprob=[-50.0],
                                                    no_speech=[0.95]))
    if case in ("max_batch", "pad_batches"):
        row = [_ts(tok, 0.0)] + _enc(tok, " x") + [_ts(tok, 1.0)]

        def make(cls, log):
            def fn(mel, ids, mask, temperature, _):
                log.append((mel.shape[0], temperature, np.asarray(ids).tolist()))
                b = mel.shape[0]
                if case == "pad_batches":  # padding rows decode junk
                    return _result(cls, [good] * 2 + [loop] * (b - 2), width=len(loop) + 4)
                return _result(cls, [row] * b)
            return fn
        if case == "pad_batches":
            return ([np.ones(int(1.5 * WIN), np.float32)],
                    dict(temperatures=(0.0, 0.4), max_batch=8, pad_batches=True), make)
        return ([np.ones(int(2.2 * WIN), np.float32), np.ones(1000, np.float32)],
                dict(max_batch=2), make)
    if case == "lcs":
        a = _enc(tok, " the patient took aspirin and felt")
        b = _enc(tok, " aspirin and felt better afterwards")
        return ([np.ones(int(1.5 * WIN), np.float32)], dict(use_timestamps=False),
                lambda cls, log: lambda m, *_: _result(cls, [a, b][: m.shape[0]]))
    assert case == "best_of"

    def make(cls, log):
        def fn(mel, ids, mask, temperature, _):
            log.append(float(temperature))
            b = mel.shape[0]
            if temperature == 0.0:
                return _result(cls, [_enc(tok, " junk")] * b, sum_logprob=[-100.0] * b)
            i = sum(1 for t in log if t > 0)
            return _result(cls, [_enc(tok, f" pick {i}")] * b,
                           sum_logprob=[-0.4 if i == 2 else -7.0] * b)
        return fn
    return ([np.zeros(16000, np.float32)],
            dict(temperatures=(0.0, 0.5), best_of=3, logprob_threshold=-1.0,
                 use_timestamps=False), make)


SCRIPTED = ["single_window", "ownership", "fallback", "silence", "max_batch", "pad_batches",
            "lcs", "best_of"]


@pytest.mark.parametrize("case", SCRIPTED)
def test_scripted_control_flow_matches_jax(tok, case):
    audios, kw, make = scripted(tok, case)
    opts = dict(temperatures=(0.0,), logprob_threshold=None, no_speech_threshold=None,
                return_segments=True, return_window_info=True,
                mel_fn=lambda c: np.zeros((np.asarray(c).shape[0], 80, 128), np.float32))
    opts.update(kw)
    logs, outs = [], []
    for cls, fn, pre in ((JaxGreedyResult, jax_chunked.transcribe_chunked, (None, jax_tiny())),
                         (GreedyResult, chunked.transcribe_chunked, (None,))):
        log = []
        extra = dict(device="cpu") if cls is GreedyResult else {}
        outs.append(fn(*pre, tok, audios, decode_fn=make(cls, log), **opts, **extra))
        logs.append(log)
    assert logs[0] == logs[1]
    assert outs[0] == outs[1]
    toks, segs, _ = outs[1]
    if case == "ownership":
        assert [t for _, _, t in segs[0]].count(" overlap segment") == 1
    if case == "pad_batches":
        assert [c[:2] for c in logs[1]] == [(8, 0.0)]  # junk padding rows drove no rung
    if case == "silence":
        assert toks == [[]]
    if case == "best_of":
        assert logs[1] == [0.0, 0.5, 0.5, 0.5]
        assert tok.decode(toks[0], skip_special_tokens=True) == " pick 2"


# ---------------------------------------------------------------------------
# the real decode
# ---------------------------------------------------------------------------

def _check_same(got, want):
    """Tokens, segments (and words) identical; window info identical up to
    the float fields' tolerances."""
    assert len(got) == len(want)
    for g, w in zip(got[:-1], want[:-1]):
        assert g == w
    for gw, ww in zip(got[-1], want[-1], strict=True):
        assert len(gw) == len(ww)
        for g, w in zip(gw, ww):
            floats = ("avg_logprob", "no_speech_prob")
            assert {k: v for k, v in g.items() if k not in floats} \
                == {k: v for k, v in w.items() if k not in floats}
            for k in floats:
                if w[k] is None:
                    assert g[k] is None
                else:
                    assert g[k] == pytest.approx(w[k], abs=1e-5)


def _spans(tok):
    spans = np.full((2, 2, 3), tok.eot, np.int32)
    spans[0, 0, :2] = _enc(tok, " aspirin")[:2]
    return spans


REAL = {
    "timestamps": dict(use_timestamps=True),
    "text": dict(use_timestamps=False),
    "beam2": dict(use_timestamps=True, num_beams=2),
    "bias_starts": dict(use_timestamps=True, bias=2.0, starts=True),
    "vad": dict(use_timestamps=False, vad=True, gappy=True),
    "words_padded": dict(use_timestamps=True, pad_batches=True, max_batch=4,
                         word_timestamps=True),
}


@pytest.mark.parametrize("case", list(REAL))
def test_transcribe_chunked_matches_jax(tok, setup, case):
    jcfg, params, model, clips = setup
    kw = dict(REAL[case])
    if kw.pop("gappy", False):
        audio = np.zeros(85 * SR, np.float32)
        audio[: 12 * SR] = clips[1]
        audio[75 * SR:] = clips[1][: 10 * SR]
        clips = [audio, clips[1]]
    if kw.pop("starts", False):
        kw["start_tokens"] = [[tok.sot], [tok.sot, tok.no_timestamps]]
    if "bias" in kw:
        kw.update(bias_spans=_spans(tok), bias_boost=kw.pop("bias"))
    common = dict(temperatures=(0.0,), max_new=8, return_segments=True,
                  return_window_info=True, prefix_pad_to_multiple=32, mel_fn=numpy_mel,
                  contexts=[_enc(tok, "aspirin"), []], **kw)
    want = jax_chunked.transcribe_chunked(params, jcfg, tok, clips, **common)
    got = chunked.transcribe_chunked(model, tok, clips, device="cpu", **common)
    if kw.get("word_timestamps"):
        as_tuples = [[(w.word, w.start, w.end, w.tokens, w.probability) for w in f]
                     for f in got[2]]
        assert as_tuples == [[(w.word, w.start, w.end, w.tokens, w.probability) for w in f]
                             for f in want[2]]
        assert all(f for f in got[2])
        got, want = got[:2] + got[3:], want[:2] + want[3:]
    _check_same(got, want)
    assert len(got[-1][0]) >= 3 or case == "vad"  # the 70 s clip took several windows
    if case == "vad":
        assert not any(20.0 < w["start_s"] < 45.0 for w in got[-1][0])  # silence skipped


def test_int16_input_matches_float_and_jax(tok, setup):
    """int16 PCM crosses as int16 and normalizes on the device: the same
    windows (and tokens) as its float32 view, in both packages."""
    jcfg, params, model, clips = setup
    pcm = (np.clip(clips[0][: 40 * SR], -1, 1) * 32767).astype(np.int16)
    seen = []

    def mel_fn(chunk):
        seen.append(np.asarray(chunk).copy())
        return numpy_mel(chunk)

    common = dict(temperatures=(0.0,), max_new=6, use_timestamps=False, mel_fn=mel_fn)
    got_i = chunked.transcribe_chunked(model, tok, [pcm], device="cpu", **common)
    got_f = chunked.transcribe_chunked(model, tok, [pcm.astype(np.float32) / 32768.0],
                                       device="cpu", **common)
    assert got_i == got_f
    assert all(c.dtype == np.float32 for c in seen)
    for a, b in zip(seen[: len(seen) // 2], seen[len(seen) // 2:]):
        np.testing.assert_array_equal(a, b)
    assert got_i == jax_chunked.transcribe_chunked(params, jcfg, tok, [pcm], **common)


def test_unported_chunked_options_raise(tok, setup):
    """A mesh raises (A.9); a draft and Medusa heads are ported: the plain
    tokens, and a draft with another n_mels refused at the t=0 rung."""
    from whisper_context_biasing_tpu_torch.models import init_medusa_params

    model = setup[2]
    clip = [np.zeros(1600, np.float32)]
    with pytest.raises(NotImplementedError, match="ROADMAP Queue A.9"):
        chunked.transcribe_chunked(model, tok, clip, device="cpu", mesh=object())
    # the timestamp rules stay off with an accelerator (as in JAX)
    kw = dict(max_new=3, temperatures=(0.0,), use_timestamps=False, device="cpu")
    plain = chunked.transcribe_chunked(model, tok, clip, **kw)
    for accel in (dict(draft=(model, model.cfg, 2)),
                  dict(medusa=init_medusa_params(model.cfg, 2))):
        assert chunked.transcribe_chunked(model, tok, clip, **accel, **kw) == plain
    other = dataclasses.replace(model.cfg, n_mels=128)
    with pytest.raises(ValueError, match="n_mels"):
        chunked.transcribe_chunked(model, tok, clip, draft=(model, other, 2), **kw)


# ---------------------------------------------------------------------------
# the entry points
# ---------------------------------------------------------------------------

def test_pipeline_chunked_matches_jax():
    """Pipeline(long_form="chunked") on the 64-state (1.28 s) window: clips
    of 4.0 and 0.6 s, timestamps, window info, a context and bias words."""
    jcfg = jax_tiny(quantize_cross_kv=True, gelu_approx=True)
    params = jax.tree.map(np.asarray, jax_init(jcfg, 0))
    ref = JaxPipeline("tiny.en", config=jcfg, params=params, model_parallelism=0)
    port = Pipeline("tiny.en", config=tiny_test_config(**FAST_OVERRIDES), params=params,
                    device="cpu")
    rng = np.random.default_rng(3)
    clips = [speech_like(rng, 4.0), speech_like(rng, 0.6)]
    kw = dict(long_form="chunked", chunked_batch=4, timestamps=True, window_info=True,
              context="patient on aspirin", bias_words=["aspirin"], bias_boost=2.0,
              max_tokens=6, temperatures=(0.0,))
    want, got = ref.transcribe(clips, **kw), port.transcribe(clips, **kw)
    assert [r.tokens for r in got] == [r.tokens for r in want]
    assert [r.segments for r in got] == [r.segments for r in want]
    assert [[w["start_s"] for w in r.windows] for r in got] \
        == [[w["start_s"] for w in r.windows] for r in want]
    assert len(got[0].windows) >= 3


@functools.cache
def jax_script():
    spec = importlib.util.spec_from_file_location(
        "wcb_transcribe", os.path.join(REPO, "scripts", "transcribe.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_transcribe_cli_chunked_matches_jax(tok, setup, tmp_path, monkeypatch, capsys):
    """``--long --chunked --timestamps --format json`` of a 42 s WAV (int16
    to the decoder) and a 5 s one, from JAX-written weights."""
    narrow = dict(n_audio_ctx=1500, d_model=32, n_heads=2, n_audio_layers=1, n_text_layers=2)
    jcfg = jax_tiny(**narrow)
    jax_save_safetensors(jax_init(jcfg, 0), jcfg, str(tmp_path / "init"))
    rng = np.random.default_rng(4)
    paths = []
    for name, seconds in (("long", 42.0), ("short", 5.0)):
        paths.append(str(tmp_path / f"{name}.wav"))
        with wave.open(paths[-1], "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(SR)
            w.writeframes((np.clip(speech_like(rng, seconds), -1, 1) * 32767)
                          .astype("<i2").tobytes())
    monkeypatch.setattr(transcribe, "get_config", lambda name, **kw: tiny_test_config(**narrow))
    monkeypatch.setattr(jax_models, "get_config", lambda name, **kw: jax_tiny(**narrow))
    argv = ["--audio", *paths, "--init_checkpoint", str(tmp_path / "init" / "model.safetensors"),
            "--max_tokens", "6", "--long", "--chunked", "--timestamps", "--format", "json",
            "--temperatures", "0.0", "--bias_words", "aspirin", "--bias_boost", "2.0"]
    transcribe.main([*argv, "--device", "cpu"])
    port = capsys.readouterr().out
    monkeypatch.setattr(sys, "argv", ["transcribe.py", *argv])
    jax_script().main()
    assert port == capsys.readouterr().out
    assert [json.loads(line)["file"] for line in port.splitlines()] == paths
