"""Port parity: the acceptance sweep (``cli/acceptance.py``) against the JAX
package's ``scripts/acceptance.py``, in the cases of its
``tests/test_acceptance.py`` (weight resolution, the reference rows and the
built-in fallback, corpus staging, the metric-parity asserts against the
committed reference artifacts, which skip as JAX's do when the reference is
not mounted), the JAX script's flag defaults, and one offline run of config
1 on the CPU whose ``acceptance.json`` has the keys of the JAX script's
committed ``acceptance_out/acceptance.json``."""

import importlib.util
import json
import os
import sys
import wave

import numpy as np
import pytest

from conftest import REFERENCE_ROOT, requires_reference
from whisper_context_biasing_tpu_torch.cli import acceptance as acc

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the test workers run side by side."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def mounted(monkeypatch):
    """The port reads the reference mirror from WCB_REFERENCE_ROOT; point it
    where the JAX tests look."""
    monkeypatch.setattr(acc, "REFERENCE_ROOT", REFERENCE_ROOT)


def test_resolution_order_and_misses(tmp_path):
    assert acc.resolve_weights(None, "tiny.en") is None
    assert acc.resolve_weights(str(tmp_path), "tiny.en") is None
    flat = tmp_path / "tiny.en.safetensors"
    flat.write_bytes(b"x")
    assert acc.resolve_weights(str(tmp_path), "tiny.en") == str(flat)
    # <dir>/<model>/model.safetensors wins over the flat file
    nested = tmp_path / "tiny.en"
    nested.mkdir()
    (nested / "model.safetensors").write_bytes(b"x")
    assert acc.resolve_weights(str(tmp_path), "tiny.en") == str(nested / "model.safetensors")


def test_native_checkpoint_dir(tmp_path):
    d = tmp_path / "base.en"
    d.mkdir()
    assert acc.resolve_weights(str(tmp_path), "base.en") is None  # no params
    (d / "params.npz").write_bytes(b"x")
    assert acc.resolve_weights(str(tmp_path), "base.en") == str(d)


@requires_reference
def test_reads_reference_jsonl_with_limit(mounted):
    rows = acc.load_rows(acc._reference("data"),
                         "medical-united-syn-med-test-jsonl/test.jsonl", 3)
    assert len(rows) == 3
    assert {"id", "file", "text", "description", "bias_words"} <= set(rows[0])


def test_builtin_fallback(tmp_path):
    rows = acc.load_rows(str(tmp_path), "missing.jsonl", 2)
    assert len(rows) == 2 and rows[0]["bias_words"] == ["aspirin"]
    assert acc.load_rows("", "missing.jsonl", 0) == rows


def test_synthesizes_missing_audio(tmp_path):
    rows = [{"id": "0", "file": "x.mp3", "text": "t", "description": "", "bias_words": []}]
    base, jsonl_dir, audio_s, real = acc.stage_corpus(str(tmp_path), "test", rows, "", "")
    assert not real and audio_s == pytest.approx(2.0)
    with open(os.path.join(jsonl_dir, "test.jsonl")) as f:
        staged = [json.loads(line) for line in f]
    assert staged[0]["file"] == "x.wav"  # the mp3 pointer rewritten to the wav
    with wave.open(os.path.join(base, "test", "x.wav")) as w:
        assert w.getframerate() == 16000 and w.getnframes() == 32000


def test_uses_real_audio_when_present(tmp_path):
    d = tmp_path / "aud" / "test"
    d.mkdir(parents=True)
    with wave.open(str(d / "r.wav"), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes(np.zeros(8000, np.int16).tobytes())
    rows = [{"id": "0", "file": "r.wav", "text": "t", "description": "", "bias_words": []}]
    base, _, audio_s, real = acc.stage_corpus(str(tmp_path / "out"), "test", rows,
                                              str(tmp_path), "aud")
    assert real and base == str(tmp_path / "aud")
    assert audio_s == pytest.approx(0.5)


@requires_reference
def test_offline_asserts_pass_on_committed_artifacts(mounted):
    out = acc.metric_parity_asserts(0.01)
    assert [a["status"] for a in out] == ["pass", "pass"]
    by = {a["assert"]: a for a in out}
    assert by["metric_parity:desc_only_dev"]["wer"] == pytest.approx(8.33, abs=0.005)
    assert by["metric_parity:baseline_test"]["bias_wer"] == pytest.approx(57.287, abs=0.005)


def test_metric_parity_skips_without_the_reference(monkeypatch):
    monkeypatch.setattr(acc, "REFERENCE_ROOT", "")
    assert [(a["status"], a["reason"]) for a in acc.metric_parity_asserts(0.01)] == \
        [("skipped", "reference artifacts not mounted")] * 2


def test_parse_args_defaults_match_jax(monkeypatch):
    spec = importlib.util.spec_from_file_location(
        "wcb_acceptance", os.path.join(REPO, "scripts", "acceptance.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(sys, "argv", ["acceptance.py"])
    want = vars(mod.parse_args())
    got = vars(acc.parse_args([]))
    assert got.pop("device") == "cuda"
    assert got == want
    assert acc.BASELINES == mod.BASELINES


def test_offline_config1_on_cpu(tmp_path, monkeypatch):
    """``--configs 1 --limit 1 --max_new 4``: tiny.en at full width on the
    CPU, offline; acceptance.json has the JAX schema, ok, and the parity
    asserts skipped; no network connection is attempted."""
    import socket

    def no_network(*a, **k):  # pragma: no cover
        raise AssertionError("the sweep must not open a connection")

    monkeypatch.setattr(socket, "create_connection", no_network)
    monkeypatch.setattr(acc, "REFERENCE_ROOT", "")
    out = tmp_path / "acc"
    summary = acc.main(["--configs", "1", "--limit", "1", "--max_new", "4",
                        "--output", str(out), "--device", "cpu"])
    with open(out / "acceptance.json") as f:
        got = json.load(f)
    assert got == json.loads(json.dumps(summary))
    with open(os.path.join(REPO, "acceptance_out", "acceptance.json")) as f:
        want = json.load(f)
    assert sorted(got) == sorted(want)
    assert sorted(got["asset_probe"]) == sorted(want["asset_probe"])
    assert [sorted(r) for r in got["configs"]] == [sorted(r) for r in want["configs"]]
    row = got["configs"][0]
    assert row["config"] == 1 and row["model"] == "tiny.en" and row["n_utts"] == 1
    assert got["ok"] and got["asserts_failed"] == 0
    assert got["asset_probe"]["egress"] is None
    assert os.path.isfile(row["artifact"])
    import torch

    if not torch.cuda.is_available():  # configs 2-5 default to the card
        with pytest.raises(RuntimeError, match="no CUDA device"):
            acc.main(["--configs", "2", "--output", str(tmp_path / "card")])
