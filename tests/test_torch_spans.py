"""The tracer of ``utils/profiling.py`` on the serving and training paths.

Off (no profiler session) a greedy decode and a training step record no
span and never open a ``record_function`` range. Under ``profile_trace``
a greedy decode gives one ``decode`` root with its encode, prefill and a
``decode.step`` a step (each with its sync and its two bias-trie spans),
counts the rows still running a step, and puts its spans in the Chrome
trace; a training step with two microbatches gives one ``train.step`` root
with its copy, two forwards, two backwards and the optimizer. On the CPU
no span has a device time."""

import collections
import json
import os

import numpy as np
import pytest
import torch

from whisper_context_biasing_tpu_torch import Pipeline
from whisper_context_biasing_tpu_torch.decode import greedy_decode, pack_prefixes
from whisper_context_biasing_tpu_torch.models import (
    FAST_OVERRIDES,
    build_model,
    tiny_test_config,
)
from whisper_context_biasing_tpu_torch.train import init_train_state
from whisper_context_biasing_tpu_torch.train.optim import AdamW
from whisper_context_biasing_tpu_torch.train.step import make_train_step
from whisper_context_biasing_tpu_torch.utils import profiling
from whisper_context_biasing_tpu_torch.utils.profiling import (
    count,
    dropped_spans,
    profile_trace,
    reset_spans,
    span,
    spans,
)

EOT = 50256
CAPS = np.array([3, 7, 5])
MAX_NEW = 10


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model():
    return build_model(tiny_test_config(quantize_cross_kv=True), seed=0, device="cpu")


def _decode(model, timings):
    """Three prompted rows with a bias word and caps of 3, 7 and 5 tokens."""
    mel = np.random.default_rng(0).standard_normal((3, 80, 128)).astype(np.float32)
    ids, mask = pack_prefixes([[50360, 71, 72, 50257], [50257], [50360, 90, 50257]], EOT)
    spans_ = np.full((3, 2, 3), EOT, np.int32)
    spans_[:, 0] = [97, 115, 112]
    return greedy_decode(model, mel, ids, mask, max_new=MAX_NEW, eot_id=EOT, bias_spans=spans_,
                         bias_boost=2.0, forced_eot_at=CAPS, device="cpu", timings=timings)


def _train_step(grad_accum=2):
    """One WeightCE step of four rows in ``grad_accum`` microbatches."""
    cfg = tiny_test_config()
    m = build_model(cfg, seed=0, device="cpu", train=True)
    opt = AdamW(lambda count: 1e-3)
    state = init_train_state(m, opt)
    step = make_train_step(cfg, opt, grad_accum=grad_accum)
    rng = np.random.default_rng(0)
    b = 4 // grad_accum
    labels = rng.integers(100, 5000, (grad_accum, b, 12))
    batch = dict(input_features=rng.standard_normal((grad_accum, b, 80, 128)).astype(np.float32),
                 decoder_input_ids=np.concatenate(
                     [np.full((grad_accum, b, 1), 50257), labels[..., :-1]], -1),
                 labels=labels, bias_spans=labels[..., 2:4][:, :, None])
    return step(state, batch)


def _children(got, parent):
    return collections.Counter(s["name"] for s in got if s["parent"] == parent["id"])


@pytest.fixture(scope="module")
def traced(model, tmp_path_factory):
    """A greedy decode under ``profile_trace``: its result, timings, spans
    and the Chrome trace's events."""
    reset_spans()
    timings = {}
    out = tmp_path_factory.mktemp("trace")
    with profile_trace(str(out)):
        res = _decode(model, timings)
    with open(os.path.join(out, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    got = spans()
    reset_spans()
    return res, timings, got, events


@pytest.mark.parametrize("route", ["decode", "train"])
def test_tracer_off_records_nothing(model, monkeypatch, route):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) with the tracer off")

    reset_spans()
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    if route == "decode":
        _decode(model, {})
    else:
        _train_step()
    count("decode.rows", 1)
    assert span("x") is span("y")
    assert spans() == [] and dropped_spans() == 0


def test_greedy_decode_spans(traced):
    res, timings, got, _ = traced
    roots = [s for s in got if s["parent"] is None]
    assert [r["name"] for r in roots] == ["decode"]
    root = roots[0]
    assert all(s["root"] == root["id"] for s in got)
    assert _children(got, root) == {"decode.encode": 1, "decode.prefill": 1,
                                    "decode.step": timings["steps"]}
    steps = [s for s in got if s["name"] == "decode.step"]
    assert len(steps) == timings["steps"] > 0
    for st in steps:
        assert _children(got, st) == {"decode.sync": 1, "decode.bias": 2}
    assert all(s["host_ms"] >= 0 and s["device_ms"] is None for s in got)
    # the children lie inside their parents, on the host clock
    by_id = {s["id"]: s for s in got}
    for s in got:
        if s["parent"] is not None:
            assert s["host_ms"] <= by_id[s["parent"]]["host_ms"]


def test_live_rows_are_the_unfinished_rows_a_step(traced):
    res, timings, got, _ = traced
    lengths = res.lengths.numpy()
    assert (lengths <= CAPS).all()
    steps = timings["steps"]
    # row i runs at step t (1-based) while it has no <|endoftext|> before t
    want = int(sum(min(int(n), steps) for n in lengths))
    root = next(s for s in got if s["parent"] is None)
    assert root["counters"] == {"decode.rows": 3, "decode.live_rows": want}


def test_spans_are_user_annotations_in_the_chrome_trace(traced):
    _, _, got, events = traced
    names = collections.Counter(e.get("name") for e in events
                                if e.get("cat") == "user_annotation")
    for name, n in collections.Counter(s["name"] for s in got).items():
        assert names[name] == n, name


def test_train_step_spans(tmp_path):
    reset_spans()
    with profile_trace(str(tmp_path)):
        _, metrics = _train_step(grad_accum=2)
    got = spans()
    reset_spans()
    assert np.isfinite(float(metrics["loss"]))
    roots = [s for s in got if s["parent"] is None]
    assert [r["name"] for r in roots] == ["train.step"]
    assert _children(got, roots[0]) == {"train.to_device": 1, "train.forward": 2,
                                        "train.backward": 2, "train.optimizer": 1}
    assert all(s["device_ms"] is None and s["host_ms"] > 0 for s in got)


def test_pipeline_mel_and_decode_roots(tmp_path):
    pipe = Pipeline("tiny.en", config=tiny_test_config(**FAST_OVERRIDES), device="cpu")
    clip = (0.1 * np.random.default_rng(1).standard_normal(16000)).astype(np.float32)
    reset_spans()
    with profile_trace(str(tmp_path)):
        pipe.transcribe([clip, clip[:8000]], bias_words=["aspirin"], bias_boost=2.0,
                        max_tokens=4)
    got = spans()
    reset_spans()
    roots = [s for s in got if s["parent"] is None]
    assert [r["name"] for r in roots] == ["mel", "decode"]
    assert _children(got, roots[0]) == {"mel.stage": 1, "mel.frontend": 1}


def test_buffer_keeps_the_first_spans_and_counts_the_rest(monkeypatch, tmp_path):
    monkeypatch.setattr(profiling, "MAX_SPANS", 3)
    reset_spans()
    with profile_trace(str(tmp_path)):
        with span("a"):
            count("n", 2)
            for _ in range(4):
                with span("b"):
                    count("n", 1)
        count("n", 5)  # outside any span: nothing
    got = spans()
    assert [s["name"] for s in got] == ["a", "b", "b"]
    assert got[0]["counters"] == {"n": 6} and dropped_spans() == 2
    reset_spans()
    assert spans() == [] and dropped_spans() == 0

