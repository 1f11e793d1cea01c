"""Port parity in float64: a ``dtype="float64"`` config computes in float64.

The port and the JAX package (under ``jax_enable_x64``) get the same weights
(the JAX init, widened to float64 for JAX and carried over with
``params_from_jax`` for the port) and the same numpy inputs. Both sides sum
in float64 in other orders, so encoder states and logits agree to 1e-10;
greedy tokens are identical. A recording of the port's torch calls checks
that its layer norms, attention softmaxes and vocab logits run in float64
rather than in f32."""

import contextlib
import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

from whisper_context_biasing_tpu.decode import greedy_decode as jax_greedy
from whisper_context_biasing_tpu.models import init_params as jax_init
from whisper_context_biasing_tpu.models import tiny_test_config as jax_tiny
from whisper_context_biasing_tpu.models.whisper import (
    decode_tokens as jax_decode_tokens,
    encode_audio as jax_encode,
)
from whisper_context_biasing_tpu_torch.decode import greedy_decode, pack_prefixes
from whisper_context_biasing_tpu_torch.models import (
    build_model,
    decode_tokens,
    encode_audio,
    params_from_jax,
    tiny_test_config,
)

ATOL = 1e-10
EOT = 50256


@contextlib.contextmanager
def enable_x64():
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", False)


@pytest.fixture(scope="module")
def setup():
    jcfg = jax_tiny(dtype="float64")
    params = jax.tree.map(np.asarray, jax_init(jax_tiny(), 0))
    cfg = tiny_test_config(dtype="float64")
    model = build_model(cfg, params_from_jax(params, cfg), device="cpu")
    mel = np.random.default_rng(0).standard_normal((2, 80, 128))
    return jcfg, params, model, mel


def _p64(params):
    return jax.tree.map(lambda a: jnp.asarray(np.asarray(a, np.float64)), params)


class _Dtypes(TorchFunctionMode):
    """The result dtypes of the torch calls named in ``watch``."""

    def __init__(self, watch):
        super().__init__()
        self.watch = watch
        self.seen = collections.defaultdict(set)

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = getattr(func, "__name__", "")
        if name in self.watch:
            self.seen[name].add(out.dtype)
        return out


def test_encoder_matches_jax_in_float64(setup):
    jcfg, params, model, mel = setup
    with enable_x64():
        ref = np.asarray(jax_encode(_p64(params), jcfg, jnp.asarray(mel)))
    got = encode_audio(model, torch.from_numpy(mel))
    assert got.dtype == torch.float64 and got.shape == (2, 64, 64)
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL, rtol=0)


def test_full_sequence_logits_match_jax_in_float64(setup):
    jcfg, params, model, mel = setup
    toks = np.random.default_rng(1).integers(0, 50000, (2, 12))
    with enable_x64():
        p64 = _p64(params)
        enc = jax_encode(p64, jcfg, jnp.asarray(mel))
        ref, _ = jax_decode_tokens(p64, jcfg, jnp.asarray(toks, jnp.int32), enc_out=enc)
        ref = np.asarray(ref)
    logits, _ = decode_tokens(model, torch.from_numpy(toks),
                              enc_out=encode_audio(model, torch.from_numpy(mel)))
    assert logits.dtype == torch.float64
    np.testing.assert_allclose(logits.numpy(), ref, atol=ATOL, rtol=0)


def test_greedy_tokens_match_jax_in_float64(setup):
    jcfg, params, model, mel = setup
    ids, mask = pack_prefixes([[50360, 71, 72, 50257], [50257]], EOT)
    with enable_x64():
        ref = jax_greedy(_p64(params), jcfg, jnp.asarray(mel), jnp.asarray(ids),
                         jnp.asarray(mask), max_new=8, eot_id=EOT)
        want = np.asarray(ref.tokens)
    got = greedy_decode(model, mel, ids, mask, max_new=8, eot_id=EOT, device="cpu")
    np.testing.assert_array_equal(got.tokens.numpy(), want)


def test_float64_activations_stay_float64(setup):
    """The layer norms, the attention weights (softmax) and the vocab logits
    (the linear layers) of the encoder and of a cached decode step compute in
    float64, not in f32."""
    _, _, model, mel = setup
    ids, mask = pack_prefixes([[50257]], EOT)
    with _Dtypes({"layer_norm", "softmax", "linear", "conv1d"}) as rec:
        greedy_decode(model, mel[:1], ids, mask, max_new=2, eot_id=EOT, device="cpu")
    assert dict(rec.seen) == {name: {torch.float64}
                              for name in ("layer_norm", "softmax", "linear", "conv1d")}
