"""Port parity for word-level timestamps: ``models/alignment.py`` (the head
sets and their resolution, ``median_filter_time``, the teacher-forced
``alignment_matrix`` and its per-token probabilities) and
``decode/word_timestamps.py`` (``dtw_path``, ``merge_punctuations``,
``split_words``, ``find_word_timestamps``) against the JAX package's, then
word timestamps through the port's Pipeline on the short-form, sequential
long-form and chunked routes against the JAX Pipeline's, and the transcribe
CLI's ``--word_timestamps --alignment_heads`` and short-form ``--format
srt|vtt`` against the JAX script's.

Tolerances: the alignment matrix within 1e-5 absolute and the probabilities
within 1e-5 (both packages fed the same encoder states: f32 sums in other
orders); the median filter, DTW paths, word splits, words and word times
identical (times are whole 20 ms frames)."""

import functools
import importlib.util
import os
import sys
import wave

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import whisper_context_biasing_tpu.models as jax_models
from whisper_context_biasing_tpu import Pipeline as JaxPipeline
from whisper_context_biasing_tpu.decode import word_timestamps as jax_wt
from whisper_context_biasing_tpu.models import alignment as jax_al
from whisper_context_biasing_tpu.models import encode_audio as jax_encode
from whisper_context_biasing_tpu.models import get_config as jax_get_config
from whisper_context_biasing_tpu.models import init_params as jax_init
from whisper_context_biasing_tpu.models import save_safetensors as jax_save_safetensors
from whisper_context_biasing_tpu.models import tiny_test_config as jax_tiny
from whisper_context_biasing_tpu_torch import Pipeline
from whisper_context_biasing_tpu_torch.cli import transcribe
from whisper_context_biasing_tpu_torch.decode import word_timestamps as wt
from whisper_context_biasing_tpu_torch.models import (
    FAST_OVERRIDES,
    build_model,
    get_config,
    params_from_jax,
    tiny_test_config,
)
from whisper_context_biasing_tpu_torch.models import alignment as al
from whisper_context_biasing_tpu_torch.tokenizer import load_tokenizer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def setup():
    tok = load_tokenizer()
    jcfg = jax_tiny()
    params = jax.tree.map(np.asarray, jax_init(jcfg, 0))
    cfg = tiny_test_config()
    model = build_model(cfg, params_from_jax(params, cfg), device="cpu")
    return tok, jcfg, params, model


def _words(ws):
    return [(w.word, w.start, w.end, w.tokens, w.probability) for w in ws]


# ---------------------------------------------------------------------------
# head sets
# ---------------------------------------------------------------------------

def test_alignment_head_sets_match_jax(setup):
    _, jcfg, _, _ = setup
    assert al.ALIGNMENT_HEADS == jax_al.ALIGNMENT_HEADS
    for name in list(al.ALIGNMENT_HEADS) + ["distil-large-v3", "large-v1"]:
        try:
            jcfg_n, cfg_n = jax_get_config(name), get_config(name)
        except ValueError:
            continue
        assert al.infer_model_name(cfg_n) == jax_al.infer_model_name(jcfg_n)
        np.testing.assert_array_equal(al.resolve_alignment_mask(cfg_n).numpy(),
                                      np.asarray(jax_al.resolve_alignment_mask(jcfg_n)))
        assert al.lookup_alignment_heads(name, cfg_n) == jax_al.lookup_alignment_heads(name,
                                                                                       jcfg_n)
    shrunk, jshrunk = get_config("base.en", n_text_layers=4), jax_get_config("base.en",
                                                                              n_text_layers=4)
    assert al.lookup_alignment_heads("base.en", shrunk) is None
    assert jax_al.lookup_alignment_heads("base.en", jshrunk) is None
    cfg = tiny_test_config()
    for heads in (None, [(0, 0)], [(0, 1), (1, 0), (9, 0), (-1, 1)]):
        np.testing.assert_array_equal(al.resolve_alignment_mask(cfg, heads).numpy(),
                                      np.asarray(jax_al.resolve_alignment_mask(jcfg, heads)))
    np.testing.assert_array_equal(al.default_alignment_mask(cfg).numpy(),
                                  np.asarray(jax_al.default_alignment_mask(jcfg)))


# ---------------------------------------------------------------------------
# host pieces
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,width", [((3, 20), 5), ((2, 2, 30), 7), ((4, 9), 1),
                                         ((2, 4), 7)])
def test_median_filter_matches_jax(shape, width):
    rng = np.random.default_rng(2)
    x = rng.standard_normal(shape).astype(np.float32)
    x[..., 3:6] = 0.25  # ties
    got = al.median_filter_time(torch.from_numpy(x), width).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_al.median_filter_time(jnp.asarray(x),
                                                                            width)))


def test_dtw_path_matches_jax():
    rng = np.random.default_rng(7)
    costs = [np.ones((6, 6)) - np.eye(6), rng.random((5, 40)), rng.random((7, 11)),
             np.array([[0, 1, 1, 1, 1], [1, 1, 0, 0, 1], [0, 0, 1, 0, 1], [0, 0, 1, 1, 0],
                       [1, 1, 1, 0, 1]], float)]
    costs += [rng.integers(0, 2, (5, 6)).astype(float) for _ in range(100)]  # tie-heavy
    for cost in costs:
        got, want = wt.dtw_path(cost), jax_wt.dtw_path(cost)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])


def test_split_words_and_punctuation_match_jax(setup):
    tok = setup[0]
    for text in (" take aspirin twice daily", " hello, world.", " café résumé",
                 ' he said "yes" loudly', " (dose) 5 mg, twice; ¿qué? ok!", ""):
        ids = tok.encode(text, add_special_tokens=False)
        got = wt.split_words(tok, ids)
        assert got == jax_wt.split_words(tok, ids)
        assert "".join(got[0]) == text
    for words, toks in (([" he", " (", " said", ")"], [[1], [2], [3], [4]]),
                        ([" stop", "."], [[1], [2]]), ([" ¿", " (", " x", "?", ")"],
                                                       [[1], [2], [3], [4], [5]])):
        assert wt.merge_punctuations(words, toks) == jax_wt.merge_punctuations(words, toks)


# ---------------------------------------------------------------------------
# the alignment pass and find_word_timestamps
# ---------------------------------------------------------------------------

def _tokens(tok, hyps, pad=3):
    seqs = [[tok.sot] + h + [tok.eot] for h in hyps]
    s = max(map(len, seqs)) + pad
    toks = np.full((len(seqs), s), tok.eot, np.int32)
    mask = np.zeros((len(seqs), s), np.float32)
    for i, q in enumerate(seqs):
        toks[i, : len(q)] = q
        mask[i, : len(q)] = 1.0
    return toks, mask


@pytest.mark.parametrize("heads,width,frames", [(None, 7, 60), ([(0, 1), (1, 0)], 7, 64),
                                                (None, 1, 40)])
def test_alignment_matrix_matches_jax(setup, heads, width, frames):
    tok, jcfg, params, model = setup
    rng = np.random.default_rng(3)
    mel = (rng.standard_normal((2, 80, 128)) * 0.5).astype(np.float32)
    hyps = [tok.encode(" take aspirin daily", add_special_tokens=False),
            tok.encode(" hello world and more words here", add_special_tokens=False)]
    toks, mask = _tokens(tok, hyps)
    enc = jax_encode(params, jcfg, jnp.asarray(mel))
    jm, jp = jax_al.alignment_matrix(params, jcfg, jnp.asarray(toks), enc,
                                     jax_al.resolve_alignment_mask(jcfg, heads),
                                     jnp.asarray(mask), num_frames=frames, medfilt_width=width,
                                     with_probs=True)
    m, p = al.alignment_matrix(model, torch.from_numpy(toks), torch.from_numpy(np.array(enc)),
                               al.resolve_alignment_mask(model.cfg, heads),
                               torch.from_numpy(mask), num_frames=frames, medfilt_width=width,
                               with_probs=True)
    assert m.shape == (2, toks.shape[1], frames)
    np.testing.assert_allclose(m.numpy(), np.asarray(jm), atol=1e-5, rtol=0)
    np.testing.assert_allclose(p.numpy(), np.asarray(jp), atol=1e-5, rtol=0)
    alone = al.alignment_matrix(model, torch.from_numpy(toks), torch.from_numpy(np.array(enc)),
                                al.resolve_alignment_mask(model.cfg, heads),
                                torch.from_numpy(mask), num_frames=frames, medfilt_width=width)
    torch.testing.assert_close(alone, m, rtol=0, atol=0)


@pytest.mark.parametrize("kw", [dict(num_frames=[64, 40]), dict(num_frames=30, pad_to=24),
                                dict(alignment_heads=[(1, 0), (1, 1)]),
                                dict(starts=True)],
                         ids=["frames", "pad_to", "heads", "starts"])
def test_find_word_timestamps_matches_jax(setup, kw):
    tok, jcfg, params, model = setup
    rng = np.random.default_rng(4)
    mel = (rng.standard_normal((3, 80, 128)) * 0.5).astype(np.float32)
    hyps = [tok.encode(" take aspirin daily, twice.", add_special_tokens=False),
            tok.encode(" hello world", add_special_tokens=False), []]
    hyps[1] = [tok.timestamp_begin] + hyps[1] + [tok.timestamp_begin + 20]  # specials dropped
    if kw.pop("starts", False):
        kw["starts"] = [[tok.sot, tok.no_timestamps]] * 3
    want = jax_wt.find_word_timestamps(params, jcfg, tok, mel, hyps, **kw)
    got = wt.find_word_timestamps(model, tok, mel, hyps, **kw)
    assert [_words(w) for w in got] == [_words(w) for w in want]
    assert got[0] and got[2] == []
    for ws in got:
        assert all(0.0 <= w.start <= w.end and 0.0 < w.probability <= 1.0 for w in ws)


# ---------------------------------------------------------------------------
# the Pipeline's routes and the transcribe CLI
# ---------------------------------------------------------------------------

def speech_like(rng, seconds):
    t = np.arange(int(seconds * 16000)) / 16000
    f0 = 110 + 40 * np.sin(2 * np.pi * rng.uniform(0.2, 0.6) * t)
    phase = 2 * np.pi * np.cumsum(f0) / 16000
    voiced = sum(np.sin(k * phase) / k for k in range(1, 6))
    env = 0.5 + 0.5 * np.sin(2 * np.pi * rng.uniform(3, 5) * t)
    return (0.1 * env * voiced + 0.005 * rng.standard_normal(t.size)).astype(np.float32)


@pytest.fixture(scope="module")
def pipelines():
    jcfg = jax_tiny(quantize_cross_kv=True, gelu_approx=True)
    params = jax.tree.map(np.asarray, jax_init(jcfg, 0))
    ref = JaxPipeline("tiny.en", config=jcfg, params=params, model_parallelism=0)
    port = Pipeline("tiny.en", config=tiny_test_config(**FAST_OVERRIDES), params=params,
                    device="cpu")
    return ref, port


@pytest.mark.parametrize("route", ["short", "short_beam", "long", "long_timestamps", "chunked"])
def test_pipeline_word_timestamps_match_jax(pipelines, route):
    """Word timestamps on each route of the Pipeline (the 64-state, 1.28 s
    window): words, word times and the segments grouped from them (or the
    timestamp segments) identical."""
    ref, port = pipelines
    rng = np.random.default_rng(6)
    short = route.startswith("short")
    clips = ([speech_like(rng, 0.7), speech_like(rng, 1.2)] if short
             else [speech_like(rng, 3.5), speech_like(rng, 0.8)])
    kw = dict(word_timestamps=True, context="patient on aspirin", bias_words=["aspirin"],
              bias_boost=2.0, max_tokens=6, temperatures=(0.0,))
    if route == "short_beam":
        kw["num_beams"] = 2
    if route.startswith("long"):
        kw.update(long_form=True, timestamps=route == "long_timestamps")
    if route == "chunked":
        kw.update(long_form="chunked", chunked_batch=4)
    want, got = ref.transcribe(clips, **kw), port.transcribe(clips, **kw)
    assert [r.tokens for r in got] == [r.tokens for r in want]
    assert [_words(r.words) for r in got] == [_words(r.words) for r in want]
    assert [r.segments for r in got] == [r.segments for r in want]
    assert all(r.words for r in got)
    for r, c in zip(got, clips):
        starts = [w.start for w in r.words]
        assert starts == sorted(starts) and r.words[-1].end <= len(c) / 16000 + 0.02


@functools.cache
def jax_script():
    spec = importlib.util.spec_from_file_location(
        "wcb_transcribe", os.path.join(REPO, "scripts", "transcribe.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


NARROW = dict(n_audio_ctx=1500, d_model=32, n_heads=2, n_audio_layers=1, n_text_layers=2)


@pytest.fixture(scope="module")
def wav_files(tmp_path_factory):
    root = tmp_path_factory.mktemp("wt_audio")
    rng = np.random.default_rng(8)
    paths = []
    for name, seconds in (("a", 2.0), ("b", 4.5)):
        paths.append(str(root / f"{name}.wav"))
        with wave.open(paths[-1], "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(16000)
            w.writeframes((np.clip(speech_like(rng, seconds), -1, 1) * 32767)
                          .astype("<i2").tobytes())
    jcfg = jax_tiny(**NARROW)
    jax_save_safetensors(jax_init(jcfg, 0), jcfg, str(root / "init"))
    return paths, str(root / "init" / "model.safetensors")


@pytest.mark.parametrize("argv", [["--word_timestamps", "--alignment_heads", "1:0,1:1"],
                                  ["--word_timestamps", "--format", "json"],
                                  ["--format", "srt"], ["--format", "vtt"]],
                         ids=["heads_text", "json", "srt", "vtt"])
def test_transcribe_cli_words_match_jax(wav_files, argv, monkeypatch, capsys):
    paths, init = wav_files
    monkeypatch.setattr(transcribe, "get_config", lambda name, **kw: tiny_test_config(**NARROW))
    monkeypatch.setattr(jax_models, "get_config", lambda name, **kw: jax_tiny(**NARROW))
    full = ["--audio", *paths, "--init_checkpoint", init, "--max_tokens", "6", *argv]
    transcribe.main([*full, "--device", "cpu"])
    port = capsys.readouterr().out
    monkeypatch.setattr(sys, "argv", ["transcribe.py", *full])
    jax_script().main()
    assert port == capsys.readouterr().out
    assert ("-->" in port) == ("--format" in argv and argv[-1] in ("srt", "vtt"))
