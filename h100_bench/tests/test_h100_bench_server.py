"""The server kind (``drivers/server.py``) on the CPU at a tiny width: the
port's ``Engine`` built from its flags, warm-up, a short window of
open-loop arrivals at a low rate, the traced segment and the check. A
sound run is correct; each fault the cell can have fails a limit; an
Engine that never answers ends the run within its window and drain,
with every request of the window failed."""

from __future__ import annotations

import copy
import json
import math
import pathlib
import threading
import time

import numpy as np
import pytest
import torch

from core import arrivals, calibrate, faults, runner
from core.weights import geometry
from drivers import server
from tiny import TINY

torch.set_num_threads(2)
SEED = 2 ** 31 + 4242
CELLS = ["serve.base.en.server", "serve.base.en.server.bursty"]
BENCH = json.loads((pathlib.Path(__file__).resolve().parents[2] / "BENCHMARK.json").read_text())
# the tiny width over the published 1500 audio positions: the Engine pads
# every clip to 30 s, as deployed
PORT = dict(d_model=64, n_heads=2, n_audio_layers=2, n_text_layers=2)


@pytest.fixture
def tiny_server(monkeypatch):
    from whisper_context_biasing_tpu_torch.models import config

    get = config.get_config
    monkeypatch.setattr(config, "get_config", lambda name, **kw: get(name, **{**kw, **PORT}))
    for name, value in dict(CLIENTS=16, CLOSE_S=20.0, TRACE_LEAD_S=0.2, TRACE_S=0.4,
                            TRACE_HOST_S=0.3, TRACE_SLACK_S=0.5).items():
        monkeypatch.setattr(server, name, value)


def tiny_spec(cell: str, check_requests: int = 3, **traffic) -> dict:
    spec = copy.deepcopy(runner.load_spec(cell))
    spec["config"].update({k: v for k, v in TINY.items() if k != "max_source_positions"})
    spec["g"] = geometry(spec["config"])
    tr = spec["traffic"]
    tr.update(batch=4, max_new=12, duration_s=[10.0, 30.0], context_tokens=[4, 40],
              corpus_token_deciles=[int(x) // 8 + 2 for x in tr["corpus_token_deciles"]],
              rate_per_s=4.0, ramp_s=0.3, drain_s=60.0,
              engine=dict(tr["engine"], batch=4, max_tokens=12, max_wait_ms=20))
    tr.update(traffic)
    spec["cell"].update(check_requests=check_requests)
    return spec


def _run(monkeypatch, cell="serve.base.en.server", fault=None, seconds=1.0, trace=False,
         check_requests=3, **traffic):
    if fault:
        orig = server.port
        monkeypatch.setattr(server, "port", lambda: fault(orig()))
    return runner.run_cell(tiny_spec(cell, check_requests, **traffic), SEED, seconds, trace,
                           "cpu")


@pytest.mark.parametrize("cell", CELLS)
def test_sound_server_run_is_correct(tiny_server, monkeypatch, cell):
    line = _run(monkeypatch, cell)
    assert line["correct"] and line["failed"] == 0, line["checks"]
    assert line["attempted"] > 0
    assert set(line["metrics"]) == {"serve_p95_ms", "setup_s"}
    assert math.isfinite(line["metrics"]["serve_p95_ms"]["value"])
    assert list(line)[-1] == "checks"
    assert set(line["checks"]) == {"served_gap", "served_gap_mean", "text_mismatch",
                                   "input_mismatch"}
    json.dumps(line)


def test_traced_server_run_reads_its_layers(tiny_server, monkeypatch):
    from whisper_context_biasing_tpu_torch.utils.profiling import reset_spans

    reset_spans()
    try:
        monkeypatch.setattr(server, "TRACE_S", 1.5)
        line = _run(monkeypatch, trace=True)
    finally:
        reset_spans()
    assert line["correct"], line["checks"]
    got = line["metrics"]
    # the CPU has no CUDA events (prefill's device ms) and replays no graph
    assert {"batch_fill.server", "batch_ms.server", "generator_lag_ms.server",
            "decode_sync_ms_per_step.server", "device_idle.server"} <= set(got)
    assert 0 < got["batch_fill.server"]["value"] <= 100
    assert got["batch_ms.server"]["value"] > 0
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    assert {"busy_s", "window_s"} <= set(line["device"])


@pytest.mark.parametrize("name", sorted(faults.SERVE) + sorted(faults.ENGINE))
def test_server_fault_is_caught(tiny_server, monkeypatch, name):
    """Batches fill past half (the half-batch fault drops the second half's
    rows) and every finished request is judged."""
    fault = {**faults.SERVE, **faults.ENGINE}[name]
    line = _run(monkeypatch, fault=fault, rate_per_s=30.0, check_requests=1000)
    assert not line["correct"], line["checks"]


def test_calibration_judges_the_program_and_its_control_on_the_same_requests(tiny_server):
    spec = tiny_spec("serve.base.en.server", check_requests=1000, rate_per_s=30.0)
    got, checked = calibrate.server_readings(spec, SEED, 1.0, control=True, dev="cpu")
    names = {"served_gap", "served_gap_mean", "text_mismatch", "input_mismatch"}
    assert set(got) == {"program", "fp8"} and all(set(r) == names for r in got.values())
    assert checked["failed"] == 0 and checked["requests"] == checked["attempted"] > 0
    limits = spec["cell"]["limits"]
    assert all(v <= limits[n] for n, v in got["program"].items()), got
    assert got["fp8"]["served_gap"] > got["program"]["served_gap"]
    swapped, _ = calibrate.server_readings(spec, SEED, 1.0, fault="row_swap", dev="cpu")
    assert swapped["fault:row_swap"]["text_mismatch"] > 0


def test_a_failed_run_leaves_the_program_as_it_found_it(tiny_server, monkeypatch):
    """The capping wrapper stands in for ``greedy_decode`` only while a
    micro-batch runs: a decode that raises (here in the Engine's own
    warm-up) leaves the module's function as it was."""
    from whisper_context_biasing_tpu_torch.decode import greedy

    orig, port = greedy.greedy_decode, server.port

    def broken(p: dict) -> dict:
        def fail(*args, **kw):
            raise RuntimeError("decode broken")

        return dict(p, greedy=fail)

    with pytest.raises(RuntimeError, match="decode broken"):
        _run(monkeypatch, fault=broken)
    assert greedy.greedy_decode is orig
    monkeypatch.setattr(server, "port", port)
    assert _run(monkeypatch)["correct"]
    assert greedy.greedy_decode is orig


def _words_dropped(p: dict) -> dict:
    """A fault of these tests, not of the program: the Engine decodes every
    request without its bias words."""
    engine = p["engine"]

    class Dropped(engine):
        def _run(self, audios, contexts, bias_word_lists, opts=None):
            return super()._run(audios, contexts, [None] * len(audios), opts)

    return dict(p, engine=Dropped)


def test_a_request_decoded_from_other_inputs_fails_input_mismatch(tiny_server, monkeypatch):
    line = _run(monkeypatch, fault=_words_dropped)
    assert line["checks"]["input_mismatch"]["value"] > 0 and not line["correct"]


def _stalled(event):
    """A fault of these tests, not of the program: once ``event`` is set,
    no micro-batch of the Engine returns."""

    def fault(p: dict) -> dict:
        engine = p["engine"]

        class Stalled(engine):
            def _run(self, *args, **kw):
                if event.is_set():
                    threading.Event().wait()
                return super()._run(*args, **kw)

        return dict(p, engine=Stalled)

    return fault


def test_an_engine_that_stops_answering_fails_within_window_and_drain(tiny_server, monkeypatch):
    """Its requests fail and the run still ends: the window, the drain, the
    Engine's close given up after ``CLOSE_S``, the clients left behind.
    The stalled micro-batch's capping wrapper hands any other caller of
    ``greedy_decode`` the function it replaced."""
    from whisper_context_biasing_tpu_torch.decode import greedy

    real = greedy.greedy_decode

    def passed_through(model, *args, **kw):
        return "passed through" if model == "probe" else real(model, *args, **kw)

    monkeypatch.setattr(greedy, "greedy_decode", passed_through)
    event = threading.Event()
    window = server.Driver.window

    def stall_midway(self, seconds):
        threading.Timer(seconds / 2, event.set).start()
        return window(self, seconds)

    monkeypatch.setattr(server.Driver, "window", stall_midway)
    t = time.perf_counter()
    monkeypatch.setattr(server, "CLOSE_S", 1.0)
    line = _run(monkeypatch, fault=_stalled(event), seconds=2.0, drain_s=1.0)
    assert not line["correct"]
    assert 0 < line["failed"] < line["attempted"]
    assert time.perf_counter() - t < 90
    assert greedy.greedy_decode("probe", None, None, None) == "passed through"


def test_arrivals_repeat_for_every_seed_and_keep_their_rate():
    spec = runner.load_spec("serve.base.en.server.bursty")
    tr = spec["traffic"]
    a = arrivals.due_times(tr, "window", 51.0)
    assert np.array_equal(a, arrivals.due_times(tr, "window", 51.0))
    assert abs(len(a) / 51.0 / tr["rate_per_s"] - 1) < 0.25
    gaps = np.diff(a)
    assert np.std(gaps) / np.mean(gaps) > 1.5   # bursty: CV 2 at shape 0.25
    p = arrivals.due_times(runner.load_spec("serve.base.en.server")["traffic"], "window", 51.0)
    assert abs(np.std(np.diff(p)) / np.mean(np.diff(p)) - 1) < 0.15


def test_requests_cover_every_shape_in_each_block_and_tokenize_to_bytes():
    spec = runner.load_spec("serve.base.en.server")
    tr, tok = spec["traffic"], spec["config"]["tokens"]
    from core import traffic

    shapes = traffic.serve_shapes(tr)
    for seed in (SEED, SEED + 1):
        reqs = [arrivals.request(tr, shapes, seed, "window", j) for j in range(64)]
        assert sorted(r["shape"] for r in reqs[:32]) == list(range(32))
        for r in reqs:
            sh = shapes[r["shape"]]
            assert len(r["context"]) == sh["ctx"] and r["cap"] == sh["cap"]
            assert [len(w) for w in r["words"]] == sh["word_lens"]
            p = arrivals.expected_prefix(r, tok)
            assert p[0] == tok["sop"] and p[-1] == tok["sot"] and len(p) == sh["ctx"] + 2
    again = arrivals.request(tr, shapes, SEED, "window", 5)
    assert again == arrivals.request(tr, shapes, SEED, "window", 5)
    assert again != arrivals.request(tr, shapes, SEED + 1, "window", 5)


def test_expected_text_is_the_byte_vocabulary_reading():
    from whisper_context_biasing_tpu_torch.tokenizer import load_tokenizer

    tok = load_tokenizer()
    rng = np.random.default_rng(3)
    for _ in range(20):
        ids = [int(x) for x in rng.integers(0, 51864, 30)] + [104, 105, 32, 50300, 300]
        assert arrivals.expected_text(ids, 50256) == tok.decode(ids, skip_special_tokens=True).strip()


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]
                                    if set(m.get("workloads", ())) == set(CELLS)])
def test_server_readers_move_the_tail_and_list_the_two_cells(metric):
    m = next(x for x in BENCH["per_layer"] if x["name"] == metric)
    assert m["moves"] == "serve_p95_ms" and metric.endswith(".server")
