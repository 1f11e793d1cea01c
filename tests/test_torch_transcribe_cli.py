"""Port parity: the transcribe CLI (``cli/transcribe.py``) against the JAX
package's ``scripts/transcribe.py``, both run in-process on the same WAV
files and the same weights (a safetensors file the JAX package writes).

Both packages' ``get_config`` are replaced by one narrow f32 config with the
real 30 s window, and the port runs with ``--device cpu``. Compared: the
printed text lines (short-form greedy with a context and bias words), the
JSON records (short-form beam search), the ``.srt`` files of ``--long
--timestamps --format srt --output_dir``, and the ``--long --timestamps``
text lines with ``--vad``; the JSON of ``--long --window_info`` equal except
``avg_logprob`` and ``no_speech_prob``, within 1e-5 (f32 sums in other
orders). ``--medusa`` (short-form and ``--long``) and ``--draft_model``
(with a narrow draft) print the plain run's lines, as the JAX script does.
The flags ported since the first slice (``--chunked``,
``--word_timestamps``, ``--alignment_heads``, short-form ``--format srt``,
``--draft_model``, ``--medusa``) are accepted and go on to read the
audio."""

import functools
import importlib.util
import json
import os
import sys
import wave

import numpy as np
import pytest

import whisper_context_biasing_tpu.models as jax_models
from whisper_context_biasing_tpu.models import init_params as jax_init
from whisper_context_biasing_tpu.models import save_safetensors as jax_save_safetensors
from whisper_context_biasing_tpu.models import tiny_test_config as jax_tiny
from whisper_context_biasing_tpu_torch.cli import transcribe
from whisper_context_biasing_tpu_torch.models import tiny_test_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NARROW = dict(n_audio_ctx=1500, d_model=32, n_heads=2, n_audio_layers=1, n_text_layers=2)


@functools.cache
def jax_script():
    spec = importlib.util.spec_from_file_location(
        "wcb_transcribe", os.path.join(REPO, "scripts", "transcribe.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def write_wav(path, audio):
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes((np.clip(audio, -1, 1) * 32767).astype("<i2").tobytes())


def speech_like(rng, seconds):
    t = np.arange(int(seconds * 16000)) / 16000
    f0 = 110 + 40 * np.sin(2 * np.pi * rng.uniform(0.2, 0.6) * t)
    phase = 2 * np.pi * np.cumsum(f0) / 16000
    voiced = sum(np.sin(k * phase) / k for k in range(1, 6))
    env = 0.5 + 0.5 * np.sin(2 * np.pi * rng.uniform(3, 5) * t)
    return 0.1 * env * voiced + 0.005 * rng.standard_normal(t.size)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """Two short clips, a 42 s one and one with 25 s of silence inside, and
    the JAX-written weights."""
    root = tmp_path_factory.mktemp("audio")
    rng = np.random.default_rng(0)
    gappy = np.concatenate([speech_like(rng, 6.0), np.zeros(25 * 16000), speech_like(rng, 5.0)])
    clips = {"a": speech_like(rng, 2.0), "b": speech_like(rng, 5.0),
             "long": speech_like(rng, 42.0), "gappy": gappy}
    paths = {}
    for name, audio in clips.items():
        paths[name] = str(root / f"{name}.wav")
        write_wav(paths[name], audio)
    jcfg = jax_tiny(**NARROW)
    jax_save_safetensors(jax_init(jcfg, 0), jcfg, str(root / "init"))
    return paths, str(root / "init" / "model.safetensors")


@pytest.fixture
def narrow(monkeypatch):
    """Both CLIs build the narrow f32 config whatever dtype and kernel
    switches they ask for."""
    monkeypatch.setattr(transcribe, "get_config", lambda name, **kw: tiny_test_config(**NARROW))
    # scripts/transcribe.py imports get_config inside main()
    monkeypatch.setattr(jax_models, "get_config", lambda name, **kw: jax_tiny(**NARROW))


def run_both(monkeypatch, capsys, argv):
    """(port stdout, JAX stdout) of one command line."""
    transcribe.main([*argv, "--device", "cpu"])
    port = capsys.readouterr().out
    monkeypatch.setattr(sys, "argv", ["transcribe.py", *argv])
    jax_script().main()
    return port, capsys.readouterr().out


def test_short_form_text_matches_jax(files, narrow, monkeypatch, capsys):
    paths, init = files
    port, ref = run_both(monkeypatch, capsys, [
        "--audio", paths["a"], paths["b"], "--init_checkpoint", init, "--max_tokens", "8",
        "--context", "patient on aspirin", "--bias_words", "aspirin", "metformin",
        "--bias_boost", "2.0"])
    assert port == ref
    assert port.count(".wav: ") == 2


def test_short_form_beam_json_matches_jax(files, narrow, monkeypatch, capsys):
    paths, init = files
    port, ref = run_both(monkeypatch, capsys, [
        "--audio", paths["a"], paths["b"], "--init_checkpoint", init, "--max_tokens", "6",
        "--num_beams", "3", "--beam_early_stopping", "true", "--format", "json"])
    assert port == ref
    assert [json.loads(line)["file"] for line in port.splitlines()] == [paths["a"], paths["b"]]


def test_long_timestamps_srt_files_match_jax(files, narrow, monkeypatch, capsys, tmp_path):
    paths, init = files
    argv = ["--audio", paths["long"], paths["b"], "--init_checkpoint", init, "--max_tokens", "8",
            "--long", "--timestamps", "--format", "srt", "--temperatures", "0.0"]
    transcribe.main([*argv, "--output_dir", str(tmp_path / "port"), "--device", "cpu"])
    monkeypatch.setattr(sys, "argv", ["transcribe.py", *argv, "--output_dir",
                                      str(tmp_path / "jax")])
    jax_script().main()
    for name in ("long.srt", "b.srt"):
        got, want = (tmp_path / "port" / name).read_text(), (tmp_path / "jax" / name).read_text()
        assert got == want, name
        assert got.startswith("1\n") and " --> " in got


def test_long_timestamps_vad_text_matches_jax(files, narrow, monkeypatch, capsys):
    paths, init = files
    port, ref = run_both(monkeypatch, capsys, [
        "--audio", paths["gappy"], "--init_checkpoint", init, "--max_tokens", "6", "--long",
        "--timestamps", "--vad", "--temperatures", "0.0", "0.4", "--best_of", "2",
        "--logprob_threshold", "nan"])
    assert port == ref and "[" in port


def test_long_window_info_json_matches_jax(files, narrow, monkeypatch, capsys):
    paths, init = files
    port, ref = run_both(monkeypatch, capsys, [
        "--audio", paths["long"], "--init_checkpoint", init, "--max_tokens", "6", "--long",
        "--window_info", "--format", "json", "--temperatures", "0.0",
        "--clip_timestamps", "0-20,31-42"])
    got, want = json.loads(port), json.loads(ref)
    gw, ww = got.pop("windows"), want.pop("windows")
    assert got == want and len(gw) == len(ww) >= 2
    for g, w in zip(gw, ww):
        for key in ("avg_logprob", "no_speech_prob"):
            assert g.pop(key) == pytest.approx(w.pop(key), abs=1e-5)
        assert g == w


# case -> (the accelerator's flags, the flags a plain run shares)
ACCEL = {
    "medusa_short": (["--medusa", "{heads}", "--medusa_chains", "2"],
                     ["--context", "on aspirin"]),
    "medusa_long": (["--medusa", "{heads}"], ["--long", "--temperatures", "0.0"]),
    "medusa_long_timestamps": (["--medusa", "{heads}"],
                               ["--long", "--timestamps", "--temperatures", "0.0"]),
    "draft_short": (["--draft_model", "tiny.en", "--spec_k", "3"],
                    ["--bias_words", "aspirin", "--bias_boost", "2.0"]),
}


@pytest.mark.parametrize("case", list(ACCEL))
def test_medusa_and_draft_match_jax(files, narrow, monkeypatch, capsys, tmp_path, case):
    """``--medusa`` (short-form with 2 chains, and ``--long``) and
    ``--draft_model`` (a random narrow draft in each package) print the JAX
    script's lines, and the plain run's (except with ``--timestamps``, whose
    rules stay off with an accelerator, as in JAX)."""
    import whisper_context_biasing_tpu_torch.models as port_models
    from whisper_context_biasing_tpu_torch.models import init_medusa_params, save_medusa

    paths, init = files
    heads = str(tmp_path / "medusa.npz")
    save_medusa(heads, init_medusa_params(tiny_test_config(**NARROW), 2, 1))
    # the draft loader's get_config (the JAX one is patched by ``narrow``)
    monkeypatch.setattr(port_models, "get_config", lambda name, **kw: tiny_test_config(**NARROW))
    accel, shared = ACCEL[case]
    clips = [paths["long"]] if "--long" in shared else [paths["a"], paths["b"]]
    base = ["--audio", *clips, "--init_checkpoint", init, "--max_tokens", "6", *shared]
    port, ref = run_both(monkeypatch, capsys, base + [a.format(heads=heads) for a in accel])
    assert port == ref and port.count(".wav: ") == len(clips)
    if "--timestamps" not in shared:
        transcribe.main([*base, "--device", "cpu"])
        assert port == capsys.readouterr().out


# the chunked mode, word timestamps, alignment heads, short-form srt and
# draft and Medusa models are ported: those flags are accepted and the run
# goes on to read the missing file
UNPORTED = {
    "chunked": (["--long", "--chunked"], None),
    "word_timestamps": (["--word_timestamps"], None),
    "alignment_heads": (["--alignment_heads", "0:1"], None),
    "short_srt": (["--format", "srt"], None),
    "draft_model": (["--draft_model", "tiny.en"], None),
    "medusa": (["--medusa", "medusa.npz"], None),
}


@pytest.mark.parametrize("case", list(UNPORTED))
def test_unported_flags_raise_before_reading_audio(case, tmp_path, monkeypatch):
    argv, item = UNPORTED[case]
    monkeypatch.setattr(transcribe, "get_config", lambda name, **kw: tiny_test_config(**NARROW))
    # the audio file does not exist (the Python or the native WAV decoder says so)
    if item is None:
        with pytest.raises((FileNotFoundError, RuntimeError), match="none.wav"):
            transcribe.main(["--audio", str(tmp_path / "none.wav"), "--device", "cpu", *argv])
        return
    with pytest.raises(NotImplementedError, match=f"ROADMAP Queue {item}"):
        transcribe.main(["--audio", str(tmp_path / "none.wav"), "--device", "cpu", *argv])


def test_transcribe_cli_defaults_to_the_card(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        transcribe.main(["--audio", str(tmp_path / "none.wav")])
