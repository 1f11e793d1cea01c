"""Ground rules of the port: it imports neither JAX nor the JAX package, its
entry points default to the card and refuse to run without one, options not
ported yet raise, and its kernel wrappers take the plain version only for
CPU tensors."""

import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import whisper_context_biasing_tpu_torch as port
from whisper_context_biasing_tpu_torch import Pipeline, ops
from whisper_context_biasing_tpu_torch.decode import greedy_decode
from whisper_context_biasing_tpu_torch.models import (
    build_model,
    decode_tokens,
    encode_audio,
    get_config,
    tiny_test_config,
)
from whisper_context_biasing_tpu_torch.ops import _build

PKG = pathlib.Path(port.__file__).parent


def test_port_imports_no_jax():
    mods = sorted("whisper_context_biasing_tpu_torch." + ".".join(p.relative_to(PKG).with_suffix("").parts)
                  for p in PKG.rglob("*.py") if p.name != "__init__.py")
    code = ("import sys, importlib\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
            " or m.split('.')[0] == 'whisper_context_biasing_tpu']\n"
            "assert not bad, bad\n"
            "print(len(sys.modules))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=PKG.parent, timeout=120)
    assert out.returncode == 0, out.stderr
    assert len(mods) >= 15


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Pipeline("tiny.en")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(tiny_test_config())
    model = build_model(tiny_test_config(), device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        greedy_decode(model, np.zeros((1, 80, 128), np.float32), [[50257]], [[True]])


@pytest.fixture(scope="module")
def pipe():
    return Pipeline("tiny.en", config=tiny_test_config(), device="cpu")


@pytest.mark.parametrize("kwargs", [
    dict(num_beams=2), dict(timestamps=True), dict(word_timestamps=True),
    dict(window_buckets=(8,)), dict(language="en"), dict(task="translate"),
    dict(long_form=True), dict(long_form="chunked"),
])
def test_unported_transcribe_options_raise(pipe, kwargs):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        pipe.transcribe(np.zeros(1600, np.float32), **kwargs)


def test_unported_paths_raise(pipe):
    with pytest.raises(NotImplementedError, match="long-form"):
        pipe.transcribe(np.zeros(pipe.window_samples + 1, np.float32))
    for kw in (dict(checkpoint="model.safetensors"), dict(draft_model="tiny.en")):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            Pipeline("tiny.en", config=tiny_test_config(), device="cpu", **kw)
    mel = np.zeros((1, 80, 128), np.float32)
    for kw in (dict(temperature=0.5), dict(no_speech_id=50361), dict(timestamp_begin=50363)):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            greedy_decode(pipe.model, mel, [[50257]], [[True]], device="cpu", **kw)
    # the full-sequence decoder mode is ported: it runs, without a cache
    enc = encode_audio(pipe.model, torch.zeros((1, 80, 128)))
    logits, cache = decode_tokens(pipe.model, torch.zeros((1, 2), dtype=torch.long),
                                  enc_out=enc)
    assert cache is None and logits.shape == (1, 2, pipe.cfg.n_vocab)
    assert torch.isfinite(logits).all()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        pipe.transcribe("clip.mp3")


def test_wrappers_count_only_kernel_launches():
    ops.reset_launch_counts()
    x = torch.zeros((1, 3200))
    ops.log_mel_spectrogram_fused(x)
    q = torch.zeros((1, 10, 1, 64))
    o, lse = ops.flash_attention_fwd(q, q, q)
    ops.flash_attention_bwd(q, q, q, o, lse, q)
    ops.flash_attention_bwd_plain(q, q, q, o, lse, q, causal=True)
    kq = torch.zeros((2, 1, 128, 64), dtype=torch.int8)
    ks = torch.ones((2, 1, 1, 128))
    ops.quant_cross_attention_step_indexed(torch.zeros((1, 1, 64)), kq, ks, kq, ks, 1, 1)
    assert sum(ops.launches.values()) == 0


@pytest.mark.parametrize("field", ["fused_ln_qkv", "fused_ln_mlp"])
def test_fused_layernorm_switches_raise(field):
    for make in (lambda **kw: get_config("base.en", **kw), tiny_test_config):
        with pytest.raises(NotImplementedError, match="ROADMAP Queue B.5"):
            make(**{field: True})


def test_kernel_sources_and_build_flags():
    assert {p.stem for p in _build.CSRC.glob("*.cu")} == set(_build.KERNELS)
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    assert _build.build_dir() == _build.build_dir()  # keyed by source hash
    assert _build.BUILD_ROOT.name == ".torch_ext_build"
