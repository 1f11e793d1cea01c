"""Port parity for sequential long-form transcription and its host-side
helpers: ``transcribe_long_batch`` against the JAX package's on a 70 s clip
and a short one (temperature 0, timestamps off and on, and beam search at
the t=0 rung), the temperature ladder, ``best_of``, the prompt reset and the
no-speech rule through one scripted ``decode_fn`` given to both packages,
the VAD gate and clip ranges, ``compression_ratio``, ``timestamp_seek``,
``split_windows``, the VAD functions and the subtitle writers.

The model is ``tiny_test_config`` with the real 30 s window (1500 encoder
states), so 70 s is a handful of windows; the JAX side runs its XLA paths,
the port the serving kernel switches' plain versions on CPU tensors. Both
packages use their (identical) numpy log-mel frontend. Tolerances: tokens,
segments, seeks and window fields identical, except ``avg_logprob`` within
1e-5 (f32 sums over 51864 logits in other orders) and ``no_speech_prob``
within 1e-5."""

import jax
import numpy as np
import pytest

from whisper_context_biasing_tpu.audio import vad as jax_vad
from whisper_context_biasing_tpu.decode import long_form as jax_lf
from whisper_context_biasing_tpu.decode.greedy import GreedyResult as JaxGreedyResult
from whisper_context_biasing_tpu.models import init_params as jax_init
from whisper_context_biasing_tpu.models import tiny_test_config as jax_tiny
from whisper_context_biasing_tpu.utils import subtitles as jax_subs
from whisper_context_biasing_tpu_torch.audio import vad
from whisper_context_biasing_tpu_torch.decode import long_form as lf
from whisper_context_biasing_tpu_torch.decode.greedy import GreedyResult
from whisper_context_biasing_tpu_torch.models import build_model, params_from_jax, tiny_test_config
from whisper_context_biasing_tpu_torch.tokenizer import load_tokenizer
from whisper_context_biasing_tpu_torch.utils import subtitles

SR = 16000
CFG = dict(n_audio_ctx=1500, quantize_cross_kv=True)
KERNELS = dict(flash_attention=True, fused_quant_cross=True)


def speech_like(rng, seconds):
    t = np.arange(int(seconds * SR)) / SR
    f0 = 110 + 40 * np.sin(2 * np.pi * rng.uniform(0.2, 0.6) * t)
    phase = 2 * np.pi * np.cumsum(f0) / SR
    voiced = sum(np.sin(k * phase) / k for k in range(1, 6))
    env = 0.5 + 0.5 * np.sin(2 * np.pi * rng.uniform(3, 5) * t)
    return (0.1 * env * voiced + 0.005 * rng.standard_normal(t.size)).astype(np.float32)


@pytest.fixture(scope="module")
def setup():
    tok = load_tokenizer()
    jcfg = jax_tiny(**CFG)
    params = jax.tree.map(np.asarray, jax_init(jcfg, 0))
    cfg = tiny_test_config(**CFG, **KERNELS)
    model = build_model(cfg, params_from_jax(params, cfg), device="cpu")
    rng = np.random.default_rng(0)
    clips = [speech_like(rng, 70.0), speech_like(rng, 12.0)]
    return tok, jcfg, params, model, clips


def _check_same(got, want, n_parts):
    """Tokens and segments identical; window info identical up to the
    float fields' tolerances."""
    assert len(got) == len(want) == n_parts
    assert got[0] == want[0]
    if n_parts > 2:
        assert got[1] == want[1]
    for gw, ww in zip(got[-1], want[-1]):
        assert len(gw) == len(ww)
        for g, w in zip(gw, ww):
            assert {k: v for k, v in g.items() if k not in ("avg_logprob", "no_speech_prob")} \
                == {k: v for k, v in w.items() if k not in ("avg_logprob", "no_speech_prob")}
            assert g["avg_logprob"] == pytest.approx(w["avg_logprob"], abs=1e-5)
            assert g["no_speech_prob"] == pytest.approx(w["no_speech_prob"], abs=1e-5)


@pytest.mark.parametrize("kw", [dict(use_timestamps=False), dict(use_timestamps=True),
                                dict(use_timestamps=True, num_beams=2)],
                         ids=["text", "timestamps", "beam2"])
def test_transcribe_long_batch_matches_jax(setup, kw):
    tok, jcfg, params, model, clips = setup
    common = dict(temperatures=(0.0,), max_new=8, return_segments=True,
                  return_window_info=True, prefix_pad_to_multiple=32,
                  contexts=[tok.encode("aspirin", add_special_tokens=False), []], **kw)
    want = jax_lf.transcribe_long_batch(params, jcfg, tok, clips, **common)
    got = lf.transcribe_long_batch(model, tok, clips, device="cpu", **common)
    _check_same(got, want, 3)
    assert len(got[2][0]) >= 3  # the 70 s clip took several windows
    if kw["use_timestamps"]:
        assert any(t >= tok.timestamp_begin for t in got[0][0])


# ---------------------------------------------------------------------------
# the ladder, best_of, the prompt reset and the no-speech rule, scripted
# ---------------------------------------------------------------------------

def scripted_decode_fn(tok, result_cls, log):
    """One deterministic decode_fn for both packages (it ignores the key or
    generator it is given). Per call it logs (temperature, prefixes) and
    returns: at t=0 a repetition loop for row 0 (fails the compression
    ratio) and a confident text for row 1, whose no-speech probability is
    high; at 0.4 a low-confidence row 0, and one sample in three confident;
    at 0.8 a confident row 0."""
    def decode_fn(mel, ids, mask, temperature, _):
        ids = np.asarray(ids)
        log.append((float(temperature), ids.tolist()))
        n = sum(1 for t, _ in log if t == temperature)
        if temperature == 0.0:
            rows = [tok.encode(" the same words" * 20, add_special_tokens=False),
                    tok.encode(" patient on aspirin", add_special_tokens=False)]
            slp = [-0.1, -0.2]
        elif temperature == 0.4:
            rows = [tok.encode(f" sample {n}", add_special_tokens=False)] * 2
            slp = [-0.5 if n % 3 == 0 else -90.0] * 2
        else:
            rows = [tok.encode(" metformin twice daily", add_special_tokens=False)] * 2
            slp = [-0.3, -0.3]
        width = max(len(r) for r in rows) + 2
        toks = np.full((2, width), tok.eot, np.int32)
        for i, r in enumerate(rows):
            toks[i, : len(r)] = r
        lens = np.asarray([len(r) for r in rows], np.int32)
        nsp = np.asarray([0.1, 0.9], np.float32)
        return result_cls(toks, lens, np.asarray(slp, np.float32), nsp)
    return decode_fn


# per case: the options, and the rung that produced each of row 0's three
# windows (every third 0.4 sample is confident; 0.8 always is)
LADDER = {
    "ladder": (dict(temperatures=(0.0, 0.4, 0.8), best_of=1), [0.8, 0.8, 0.4]),
    "best_of": (dict(temperatures=(0.0, 0.4, 0.8), best_of=3), [0.4, 0.4, 0.4]),
    "no_prompt_reset": (dict(temperatures=(0.0, 0.4, 0.8), best_of=1,
                             prompt_reset_on_temperature=None), [0.8, 0.8, 0.4]),
    "no_speech_off": (dict(temperatures=(0.0, 0.4), best_of=2, no_speech_threshold=None),
                      [0.4, 0.4, 0.4]),
}


@pytest.mark.parametrize("case", list(LADDER))
def test_ladder_rules_match_jax_with_one_decode_fn(setup, case):
    tok, jcfg, params, model, _ = setup
    kw, temps = LADDER[case]
    rng = np.random.default_rng(1)
    clips = [speech_like(rng, 75.0), speech_like(rng, 40.0)]
    logs, outs = [], []
    for pkg, fn, cls, m in (("jax", jax_lf.transcribe_long_batch, JaxGreedyResult, params),
                            ("port", lf.transcribe_long_batch, GreedyResult, model)):
        log = []
        extra = dict(device="cpu") if pkg == "port" else {}
        args = (m, tok) if pkg == "port" else (m, jcfg, tok)
        outs.append(fn(*args, clips, decode_fn=scripted_decode_fn(tok, cls, log),
                       mel_fn=lambda c: np.zeros((c.shape[0], 80, 3000), np.float32),
                       return_segments=True, return_window_info=True, **kw, **extra))
        logs.append(log)
    assert logs[0] == logs[1]  # the same rungs, samples and history prompts
    assert outs[0] == outs[1]
    toks, segs, winfo = outs[1]
    assert [w["temperature"] for w in winfo[0]] == temps
    # row 1 is confident at t=0 though P(nospeech) is 0.9: it is kept
    assert [w["temperature"] for w in winfo[1]] == [0.0, 0.0] and len(segs[1]) == 2
    # window 2's prompt for row 0: the 0.8 rung of window 1 cleared the
    # history unless the reset is off
    window2 = [ids for t, ids in logs[1] if t == 0.0][1][0]
    assert (tok.sop in window2) == (case == "no_prompt_reset" or temps[0] < 0.5)


def test_no_speech_rule_silences_unconfident_windows(setup):
    """A high P(<|nospeech|>) with a low average logprob: nothing is emitted
    and the seek advances a full window, in both packages."""
    tok, jcfg, params, model, _ = setup
    clip = np.zeros(50 * SR, np.float32)
    outs = []
    for pkg, cls in (("jax", JaxGreedyResult), ("port", GreedyResult)):
        def decode_fn(mel, ids, mask, temperature, _, cls=cls):
            row = tok.encode(" noise", add_special_tokens=False)
            toks = np.full((1, len(row)), tok.eot, np.int32)
            toks[0, : len(row)] = row
            return cls(toks, np.asarray([len(row)], np.int32),
                       np.asarray([-20.0], np.float32), np.asarray([0.95], np.float32))
        kw = dict(decode_fn=decode_fn, temperatures=(0.0,), return_window_info=True,
                  mel_fn=lambda c: np.zeros((c.shape[0], 80, 3000), np.float32))
        if pkg == "jax":
            outs.append(jax_lf.transcribe_long_batch(params, jcfg, tok, [clip], **kw))
        else:
            outs.append(lf.transcribe_long_batch(model, tok, [clip], device="cpu", **kw))
    assert outs[0] == outs[1]
    assert outs[1][0] == [[]] and [w["start_s"] for w in outs[1][1][0]] == [0.0, 30.0]


# ---------------------------------------------------------------------------
# the VAD gate and clip ranges
# ---------------------------------------------------------------------------

def _gappy(rng):
    """Speech 0-12 s, digital silence 12-75 s, speech 75-85 s."""
    audio = np.zeros(85 * SR, np.float32)
    audio[: 12 * SR] = speech_like(rng, 12.0)
    audio[75 * SR:] = speech_like(rng, 10.0)
    return audio


@pytest.mark.parametrize("gate", [True, {"pad_ms": 300.0}, [(0.0, 5.0), (70.0, 80.0)]],
                         ids=["vad", "vad_options", "clip_ranges"])
def test_vad_and_clip_ranges_match_jax(setup, gate):
    tok, jcfg, params, model, _ = setup
    audio = _gappy(np.random.default_rng(2))
    common = dict(temperatures=(0.0,), max_new=4, vad=gate, return_window_info=True,
                  prefix_pad_to_multiple=32)
    want = jax_lf.transcribe_long_batch(params, jcfg, tok, [audio], **common)
    got = lf.transcribe_long_batch(model, tok, [audio], device="cpu", **common)
    _check_same(got, want, 2)
    starts = [w["start_s"] for w in got[1][0]]
    assert not any(20.0 < s < 60.0 for s in starts)  # the silence never reached the decoder


def test_vad_functions_match_jax():
    rng = np.random.default_rng(5)
    audio = _gappy(rng)
    quiet = (1e-4 * rng.standard_normal(3 * SR)).astype(np.float32)
    for a in (audio, quiet, np.zeros(0, np.float32), (audio * 32767).astype(np.int16)):
        for kw in ({}, {"margin_db": 4.0, "min_silence_ms": 100.0}):
            assert vad.speech_segments(a, **kw) == jax_vad.speech_segments(a, **kw)
    segs = vad.speech_segments(audio)
    for start, end, tol in ((0, 30 * SR, 0), (20 * SR, 50 * SR, 0), (11 * SR, 41 * SR, 4000)):
        assert vad.has_speech(segs, start, end, tol) == jax_vad.has_speech(segs, start, end, tol)
        assert vad.next_onset(segs, start, tol) == jax_vad.next_onset(segs, start, tol)
    for v in (True, False, None, {"pad_ms": 80.0}, [(1.0, 2.0)], [(5.0, 6.0), (1.0, 5.5)], []):
        assert vad.resolve_vad(v, audio) == jax_vad.resolve_vad(v, audio)
        assert vad.vad_overlap_tol(v) == jax_vad.vad_overlap_tol(v)
    for bad in ({"bogus": 1}, [(3.0, 2.0)]):
        for mod in (vad, jax_vad):
            with pytest.raises(ValueError):
                mod.resolve_vad(bad, audio)


# ---------------------------------------------------------------------------
# helpers and subtitles
# ---------------------------------------------------------------------------

def test_helpers_match_jax(setup):
    tok = setup[0]
    for text in ("", "the patient takes aspirin", "the same words " * 40, "é" * 30):
        assert lf.compression_ratio(text) == jax_lf.compression_ratio(text)
        for lp in (None, -0.5, -2.0):
            assert lf.window_quality_ok(text, lp) == jax_lf.window_quality_ok(text, lp)
    tb = tok.timestamp_begin
    for row in ([], [5, 6], [tb, 5, 6, tb + 100, 7], [tb, 5, tb + 40, tb + 40, 8, 9],
                [tb, 5]):
        assert lf.timestamp_seek(row, tok) == jax_lf.timestamp_seek(row, tok)
    audio = np.arange(70_000, dtype=np.float32)
    for w in (30_000, 70_000, 100_000):
        for a, b in zip(lf.split_windows(audio, w), jax_lf.split_windows(audio, w), strict=True):
            np.testing.assert_array_equal(a, b)
    for flags in ({}, dict(return_segments=True), dict(return_window_info=True),
                  dict(return_segments=True, return_window_info=True)):
        parts = ("hyps",) + (("segs",) if flags.get("return_segments") else ()) + (
            ("winfo",) if flags.get("return_window_info") else ())
        out = parts if len(parts) > 1 else "hyps"
        assert lf.unpack_long_form(out, **flags) == jax_lf.unpack_long_form(out, **flags)


class Word:
    def __init__(self, word, start, end):
        self.word, self.start, self.end = word, start, end


def test_subtitles_match_jax():
    segs = [(0.0, 2.5, " hello there"), (2.5, None, " open"), (3661.2, 3662.0, "late ")]
    closed = subtitles.close_open_segments(segs, clip_end=2.8)
    assert closed == jax_subs.close_open_segments(segs, clip_end=2.8)
    assert subtitles.close_open_segments(segs[1:2]) == jax_subs.close_open_segments(segs[1:2])
    assert subtitles.format_srt(closed) == jax_subs.format_srt(closed)
    assert subtitles.format_vtt(closed) == jax_subs.format_vtt(closed)
    words = [Word(f" w{i}", 0.4 * i, 0.4 * i + 0.3) for i in range(30)]
    words[10].start += 2.0  # a silence gap
    for kw in ({}, dict(max_words=5), dict(max_duration=2.0, max_gap=0.5)):
        assert subtitles.words_to_segments(words, **kw) == jax_subs.words_to_segments(words, **kw)
