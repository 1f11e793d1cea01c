"""Port parity: the metrics layer (normalizer, corpus WER, B-WER, scoring and
its refs_and_pred.txt artifact) vs the JAX package.

The port's copies must give the JAX package's values exactly: on the cases
of ``tests/test_metrics.py``, on seeded random strings (punctuation,
brackets, diacritics, full-width and bias words), and on the reference's
committed eval artifacts (the four published pins, where the reference repo
is mounted)."""

import dataclasses
import os

import numpy as np
import pytest

from conftest import REFERENCE_ROOT, requires_reference
from whisper_context_biasing_tpu import metrics as jax_metrics
from whisper_context_biasing_tpu_torch import metrics
from whisper_context_biasing_tpu_torch.tokenizer import load_tokenizer

NORMALIZER_CASES = [
    ("Hello, World!", "hello world "),
    ("keep <noise> this [um] and (cough) that", "keep this and that"),
    ("co-trimoxazole 5mg/ml", "co trimoxazole 5mg ml"),
    ("a   b\t\nc", "a b c"),
    ("naïve café", "naïve café"),
    ("ＡＢＣ", "abc"),
]


@pytest.mark.parametrize("text,want", NORMALIZER_CASES)
def test_normalizer_cases(text, want):
    assert metrics.BasicTextNormalizer()(text) == want
    assert jax_metrics.BasicTextNormalizer()(text) == want


def test_normalizer_remove_diacritics():
    text = "naïve café øre straße"
    for mod in (metrics, jax_metrics):
        assert mod.BasicTextNormalizer(remove_diacritics=True)(text) == "naive cafe ore strasse"


WER_CASES = [
    (["a b c"], ["a b c"], 0.0),
    (["a b c"], ["a x c"], 1 / 3),
    (["a b"], ["a b c"], 1 / 2),
    (["a b c"], ["a c"], 1 / 3),
    (["a b", "w x y z"], ["a c", "w x y z"], 1 / 6),
]


@pytest.mark.parametrize("refs,hyps,want", WER_CASES)
def test_wer_cases(refs, hyps, want):
    assert metrics.corpus_wer(refs, hyps) == pytest.approx(want)
    assert metrics.corpus_wer(refs, hyps) == jax_metrics.corpus_wer(refs, hyps)


BIAS_CASES = [
    (["take aspirin daily"], ["take aspirin daily"], [["aspirin"]]),
    (["take aspirin daily"], ["take a spin daily"], [["aspirin"]]),
    (["he has acid reflux now"], ["he has acid redux now"], [["acid reflux"]]),
    (["no mention here"], ["ibuprofen everywhere"], [["ibuprofen"]]),
    (["aspirin once"], ["aspirin aspirin aspirin"], [["aspirin"]]),
]


@pytest.mark.parametrize("refs,preds,bias", BIAS_CASES)
def test_bias_wer_cases(refs, preds, bias):
    got = metrics.compute_bias_wer_from_words(refs, preds, bias)
    want = jax_metrics.compute_bias_wer_from_words(refs, preds, bias)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


_WORDS = ["aspirin", "metformin", "acid", "reflux", "take", "daily", "the", "dose",
          "mg", "co-trimoxazole", "naïve", "café", "øre", "straße", "ＡＢＣ", "5mg/ml"]
_NOISE = [",", ".", "!", "?", ";", " <noise>", " [um]", " (cough)", "  ", "\t", "—", "%"]


def _random_text(rng, n_words):
    out = []
    for _ in range(n_words):
        out.append(str(rng.choice(_WORDS)))
        if rng.random() < 0.3:
            out.append(str(rng.choice(_NOISE)))
    return " ".join(out).title() if rng.random() < 0.3 else " ".join(out)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_strings_match_jax(seed):
    rng = np.random.default_rng(seed)
    texts = [_random_text(rng, int(rng.integers(0, 12))) for _ in range(40)]
    for remove in (False, True):
        n, jn = (m.BasicTextNormalizer(remove_diacritics=remove) for m in (metrics, jax_metrics))
        assert [n(t) for t in texts] == [jn(t) for t in texts]
    norm = metrics.BasicTextNormalizer()
    refs = [norm(t) for t in texts[:20]]
    hyps = [norm(t) for t in texts[20:]]
    assert metrics.corpus_wer(refs, hyps) == jax_metrics.corpus_wer(refs, hyps)
    for r, h in zip(refs, hyps):
        assert (metrics.word_edit_distance(r.split(), h.split())
                == jax_metrics.word_edit_distance(r.split(), h.split()))
    bias = [[str(w) for w in rng.choice(_WORDS[:6], int(rng.integers(0, 3)), replace=False)]
            for _ in refs]
    got = metrics.compute_bias_wer_from_words(refs, hyps, bias)
    want = jax_metrics.compute_bias_wer_from_words(refs, hyps, bias)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


@pytest.fixture(scope="module")
def tok():
    return load_tokenizer()


def test_score_predictions_and_artifact_match_jax(tok, tmp_path):
    rng = np.random.default_rng(3)
    texts = [_random_text(rng, int(rng.integers(1, 8))) for _ in range(12)]
    labels = [tok.encode(t) for t in texts[:6]] + [tok.encode("ignore_time_segment_in_scoring")]
    preds = [tok.encode(t, add_special_tokens=False) for t in texts[6:]] + [[]]
    labels[0] = [-100, -100] + labels[0]  # masked prompt positions
    paths = [str(tmp_path / f"{name}.txt") for name in ("port", "jax")]
    got = metrics.score_predictions(preds, labels, tok, refs_pred_file=paths[0])
    want = jax_metrics.score_predictions(preds, labels, tok, refs_pred_file=paths[1])
    assert got == want
    assert open(paths[0]).read() == open(paths[1]).read()
    refs, hyps = metrics.parse_refs_and_pred_file(paths[0])
    assert (refs, hyps) == jax_metrics.parse_refs_and_pred_file(paths[1])
    assert len(refs) == 6  # the ignore row is dropped
    spans = [[tok.encode(w, add_special_tokens=False) for w in ("aspirin", "acid reflux")]] * 6
    assert (metrics.compute_bias_wer(paths[0], spans, tok)
            == jax_metrics.compute_bias_wer(paths[1], spans, tok))


def test_score_predictions_artifact_parses_back(tok, tmp_path):
    labels = [tok.encode("take aspirin daily"), tok.encode("plain words")]
    preds = [tok.encode("take aspirin", add_special_tokens=False),
             tok.encode("plain word", add_special_tokens=False)]
    path = str(tmp_path / "rp.txt")
    out = metrics.score_predictions(preds, labels, tok, refs_pred_file=path)
    assert out["wer"] > 0
    assert metrics.parse_refs_and_pred_file(path) == (["take aspirin daily", "plain words"],
                                                      ["take aspirin", "plain word"])


# the reference's committed artifacts: (artifact, bias jsonl, rows, WER, B-WER,
# (distance, tokens)) — tests/test_metrics.py's pins
PINS = {
    "desc_only_dev": ("results/refs_and_pred_desc_only.txt",
                      "data/all_dev_with_bias_list.jsonl", 4842, 8.33,
                      45.05212267714156, (5964, 13238)),
    "baseline_test": ("results/refs_and_pred_baseline_ko_prompt.txt",
                      "data/medical-united-syn-med-75-jsonl/test.jsonl", 5114, 12.40,
                      57.28744939271255, (7358, 12844)),
}


@requires_reference
@pytest.mark.parametrize("pin", list(PINS))
def test_reference_pins(pin):
    import json

    artifact, jsonl, rows, wer, bwer, counts = PINS[pin]
    refs, preds = metrics.parse_refs_and_pred_file(os.path.join(REFERENCE_ROOT, artifact))
    assert len(refs) == rows
    assert 100 * metrics.corpus_wer(refs, preds) == pytest.approx(wer, abs=0.005)
    with open(os.path.join(REFERENCE_ROOT, jsonl)) as f:
        bias = [[w.lower() for w in json.loads(line).get("bias_words", [])]
                for line in f if line.strip()]
    r = metrics.compute_bias_wer_from_words(refs, preds, bias)
    assert r.bias_wer == pytest.approx(bwer, abs=1e-9)
    assert (r.total_distance, r.total_tokens) == counts
