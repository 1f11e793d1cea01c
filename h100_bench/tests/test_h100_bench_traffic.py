"""The traffic generator: the same seed gives the same inputs, every seed
the same set of sizes, and the sizes lie in the mix's ranges."""

import numpy as np

from core import traffic
from core.runner import load_spec

SEED = 2 ** 31 + 12345


def _mix(cell):
    spec = load_spec(cell)
    return spec["traffic"], spec["config"]["tokens"]


def test_serve_batches_repeat_per_seed_and_keep_their_sizes():
    tr, _ = _mix("serve.base.en.biased32")
    shapes = traffic.serve_shapes(tr)
    a, b = (traffic.serve_batch(tr, shapes, SEED, 3) for _ in range(2))
    assert a == b
    other = traffic.serve_batch(tr, shapes, SEED + 1, 3)
    assert other != a
    for batch in (a, other):
        assert sorted(r["shape"] for r in batch["rows"]) == list(range(tr["batch"]))
        assert sorted(r["cap"] for r in batch["rows"]) == sorted(s["cap"] for s in shapes)


def test_serve_shapes_lie_in_the_mix_ranges():
    tr, _ = _mix("serve.base.en.biased32")
    shapes = traffic.serve_shapes(tr)
    assert len(shapes) == tr["batch"] == 32
    sr = tr["sample_rate"]
    for s in shapes:
        assert 5.0 * sr <= s["samples"] <= 30.0 * sr
        assert 1 <= s["cap"] < tr["max_new"]
        assert 16 <= s["ctx"] <= 64
        assert 3 <= len(s["word_lens"]) <= 8
        assert all(1 <= n <= 4 for n in s["word_lens"])
    batch = traffic.serve_batch(tr, shapes, SEED, 0)
    ids = [t for r in batch["rows"] for t in r["ctx"] + sum(r["words"], [])]
    assert 0 <= min(ids) and max(ids) < 50256


def test_serve_caps_follow_the_corpus_deciles_scaled_by_duration():
    tr, _ = _mix("serve.base.en.biased32")
    shapes = traffic.serve_shapes(tr)
    for s in shapes:
        dur = s["samples"] / tr["sample_rate"]
        assert s["cap"] <= max(1, (160 - 1) * dur / 30.0) + 1e-9
    assert max(s["cap"] for s in shapes) > 60


def test_audio_is_the_same_for_a_seed():
    x = traffic.audio_clip(SEED, 1, 2, 16000, 0.1)
    assert np.array_equal(x, traffic.audio_clip(SEED, 1, 2, 16000, 0.1))
    assert not np.array_equal(x, traffic.audio_clip(SEED + 1, 1, 2, 16000, 0.1))
    assert x.dtype == np.float32 and abs(float(x.std()) - 0.1) < 0.01


def test_train_rows_repeat_and_hold_their_spans():
    tr, tok = _mix("train.large-v3.weightce")
    shapes = traffic.train_shapes(tr)
    rows = traffic.train_rows(tr, shapes, SEED, 1, tok)
    again = traffic.train_rows(tr, shapes, SEED, 1, tok)
    assert [r["label"] for r in rows] == [r["label"] for r in again]
    assert all(np.array_equal(a["audio"], b["audio"]) for a, b in zip(rows, again))
    other = traffic.train_rows(tr, shapes, SEED + 1, 1, tok)
    assert sorted(len(r["label"]) for r in other) == sorted(len(r["label"]) for r in rows)
    for r in rows:
        lab = r["label"]
        assert lab[0] == tok["sop"] and lab[-1] == tok["eot"] and len(lab) <= tr["max_label"]
        start = lab.index(tok["sot"])
        assert lab[start:start + len(tok["prompt_start"])] == tok["prompt_start"]
        assert 16 <= start - 1 <= 120
        trans = lab[start + len(tok["prompt_start"]):-1]
        assert 3 <= len(r["spans"]) <= 8
        for sp in r["spans"]:
            assert 1 <= len(sp) <= 4
            assert any(trans[j:j + len(sp)] == sp for j in range(len(trans)))


def test_dense_spans_pad_with_the_given_id():
    out = traffic.dense_spans([[[1, 2], [3]], [[4, 5, 6]]], 50256)
    assert out.shape == (2, 2, 3) and out.dtype == np.int32
    assert out.tolist() == [[[1, 2, 50256], [3, 50256, 50256]],
                            [[4, 5, 6], [50256, 50256, 50256]]]
