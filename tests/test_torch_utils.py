"""Port parity: the runtime utilities (``utils/flops.py``, ``debug.py``,
``compile_count.py`` and ``profiling.py``) against the JAX package's.

The FLOPs model gives the JAX package's numbers for every model family; the
checks raise the JAX package's exceptions with its messages; ``counted_jit``
counts call signatures as JAX's ``CountedJit`` does; the decoders count
theirs; ``StepTimer`` and ``profile_trace`` run on the CPU."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisper_context_biasing_tpu.models import get_config as jax_get_config
from whisper_context_biasing_tpu.models import tiny_test_config as jax_tiny
from whisper_context_biasing_tpu.models.config import _FAMILY
from whisper_context_biasing_tpu.utils import compile_count as jax_cc
from whisper_context_biasing_tpu.utils import debug as jax_debug
from whisper_context_biasing_tpu.utils import flops as jax_flops
from whisper_context_biasing_tpu_torch.decode import greedy_decode
from whisper_context_biasing_tpu_torch.models import build_model, get_config, tiny_test_config
from whisper_context_biasing_tpu_torch.utils import (
    StepTimer,
    assert_shape,
    counted_jit,
    debug_assert_finite,
    finite_check,
    profile_trace,
)
from whisper_context_biasing_tpu_torch.utils import flops


def _names():
    out = []
    for base in _FAMILY:
        stem = base[len("distil-"):] if base.startswith("distil-") else base
        if base not in ("distil-small", "distil-medium"):
            out.append(base)
        if not stem.startswith("large"):
            out.append(base + ".en")
    return out


@pytest.mark.parametrize("name", _names() + ["tiny_test"])
def test_flops_match_jax(name):
    if name == "tiny_test":
        cfg, jcfg = tiny_test_config(), jax_tiny()
    else:
        cfg, jcfg = get_config(name), jax_get_config(name)
    for fn, args in (("mel_flops", ()), ("mel_flops", (800,)), ("encoder_flops", ()),
                     ("encoder_flops", (1500,)), ("decoder_train_flops", (448,)),
                     ("train_step_flops", (8, 448, 2)), ("decode_flops", (64, 3)),
                     ("decode_flops", (10, 1, 800, False))):
        assert getattr(flops, fn)(cfg, *args) == getattr(jax_flops, fn)(jcfg, *args), fn
    assert flops.train_step_flops(cfg, 4, 32, freeze_encoder=True) == \
        jax_flops.train_step_flops(jcfg, 4, 32, freeze_encoder=True)


def test_peak_flops(monkeypatch):
    monkeypatch.setenv("BENCH_PEAK_TFLOPS", "123")
    assert flops.device_peak_flops() == jax_flops.device_peak_flops() == 123e12
    monkeypatch.delenv("BENCH_PEAK_TFLOPS")
    assert flops.device_peak_flops(torch.device("cpu")) is None
    # NVIDIA's H100 datasheet, SXM part, dense bf16: the figure kernel bounds use
    assert flops.H100_BF16_FLOPS == 989e12


def _raised(fn, *args):
    with pytest.raises(Exception) as info:
        fn(*args)
    return type(info.value), str(info.value)


@pytest.mark.parametrize("tree", [
    {"a": [1.0, float("nan")]},
    {"w": {"b": [np.inf]}, "ok": [1.0]},
    {"x": [[1.0], [2.0, -np.inf]]},
])
def test_finite_check_matches_jax(tree):
    def port(t):
        if isinstance(t, dict):
            return {k: port(v) for k, v in t.items()}
        if t and isinstance(t[0], list):
            return [port(v) for v in t]
        return torch.tensor(t, dtype=torch.bfloat16)

    def ref(t):
        if isinstance(t, dict):
            return {k: ref(v) for k, v in t.items()}
        if t and isinstance(t[0], list):
            return [ref(v) for v in t]
        return jnp.asarray(t, dtype=jnp.bfloat16)

    assert _raised(finite_check, port(tree), "params") == \
        _raised(jax_debug.finite_check, ref(tree), "params")
    finite_check({"a": torch.ones(2, dtype=torch.bfloat16), "i": torch.arange(3)})
    finite_check({"a": np.ones(2), "n": None})


@pytest.mark.parametrize("shape,want", [((2, 3), (2, None)), ((2, 3), (2, 4)),
                                        ((2, 3), (2, 3, 1)), ((5,), (None,))])
def test_assert_shape_matches_jax(shape, want):
    port_err = ref_err = None
    try:
        assert_shape(torch.zeros(shape), want, "x")
    except ValueError as e:
        port_err = str(e)
    try:
        jax_debug.assert_shape(jnp.zeros(shape), want, "x")
    except ValueError as e:
        ref_err = str(e)
    assert port_err == ref_err


def test_debug_assert_finite():
    x = torch.ones(3)
    assert debug_assert_finite(x, "x") is x
    with pytest.raises(RuntimeError, match="non-finite values in x"):
        debug_assert_finite(torch.tensor([1.0, float("nan")]), "x")


def test_counted_jit_counts_signatures_as_jax():
    def f(x, n=1, flag=False):
        return x * n

    port = counted_jit(f)
    ref = jax_cc.counted_jit(f, static_argnames=("n", "flag"))
    calls = [((np.ones(3),), {}), ((np.ones(3),), {}), ((np.ones(4),), {}),
             ((np.ones(3, np.float32),), {"n": 2}), ((np.ones(3, np.float32),), {"n": 2}),
             ((np.ones(3, np.float32),), {"flag": True})]
    for a, k in calls:
        port(torch.as_tensor(a[0]), **k)
        ref(jnp.asarray(a[0]), **k)
    assert port.cache_size() == ref.cache_size() == 4
    port.clear_cache()
    assert port.cache_size() == 0
    with pytest.raises(TypeError):
        port(torch.ones(2), bad=1)
    assert port.cache_size() == 0  # a failed call counts nothing
    assert port.__name__ == "f"


def test_greedy_decode_counts_signatures():
    model = build_model(tiny_test_config(n_audio_layers=1, n_text_layers=1), device="cpu")
    greedy_decode.clear_cache()
    mel = np.zeros((2, 80, 128), np.float32)
    ids, mask = np.full((2, 1), 50257), np.ones((2, 1), bool)
    for max_new in (2, 2, 3):
        greedy_decode(model, mel, ids, mask, max_new=max_new, device="cpu")
    greedy_decode(model, mel[:1], ids[:1], mask[:1], max_new=2, device="cpu")
    assert greedy_decode.cache_size() == 3


def test_step_timer_and_profile_trace(tmp_path):
    timer = StepTimer(warmup=1)
    for _ in range(3):
        with timer:
            torch.ones(64, 64) @ torch.ones(64, 64)
    assert len(timer.times) == 2 and 0 < timer.best <= timer.mean
    assert np.isnan(StepTimer().mean)
    with profile_trace(str(tmp_path / "trace")) as prof:
        torch.ones(32, 32) @ torch.ones(32, 32)
    assert any("mm" in e.key for e in prof.key_averages())
    with open(os.path.join(tmp_path, "trace", "trace.json")) as f:
        assert json.load(f)["traceEvents"]
