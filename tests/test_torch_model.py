"""Port parity: the Whisper model functions vs the JAX package in f32.

Both packages get the same weights (the JAX init, carried over with
``params_from_jax``) and the same numpy inputs; the port's kernel switches
are on, so on the CPU its kernel wrappers run their plain versions."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisper_context_biasing_tpu.models import init_params as jax_init
from whisper_context_biasing_tpu.models import tiny_test_config as jax_tiny
from whisper_context_biasing_tpu.models.whisper import (
    decode_tokens as jax_decode_tokens,
    encode_audio as jax_encode,
    init_kv_cache as jax_init_cache,
    precompute_cross_kv as jax_cross_kv,
    quantize_cross_kv as jax_quantize,
)
from whisper_context_biasing_tpu_torch.models import (
    build_model,
    decode_tokens,
    encode_audio,
    init_kv_cache,
    init_state_dict,
    params_from_jax,
    precompute_cross_kv,
    quantize_cross_kv,
    tiny_test_config,
)

# f32 on both sides (the JAX tests pin full-f32 matmuls); sums run in other
# orders through a few layers
ATOL = 1e-4
KERNELS = dict(flash_attention=True, quantize_cross_kv=True, fused_quant_cross=True)


@pytest.fixture(scope="module")
def setup():
    jcfg = jax_tiny()
    params = jax.tree.map(np.asarray, jax_init(jcfg, 0))
    cfg = tiny_test_config(**KERNELS)
    model = build_model(cfg, params_from_jax(params, cfg), device="cpu")
    mel = np.random.default_rng(0).standard_normal((2, 80, 128)).astype(np.float32)
    return jcfg, params, cfg, model, mel


def test_params_from_jax_fills_every_weight(setup):
    _, params, cfg, model, _ = setup
    sd = params_from_jax(params, cfg)
    assert set(sd) == set(model.state_dict())
    np.testing.assert_array_equal(sd["decoder.blocks.1.cross_attn.key.weight"].numpy(),
                                  params["decoder"]["cross_attn"]["wk"][1].T)
    np.testing.assert_array_equal(sd["encoder.conv1.weight"].numpy(),
                                  params["encoder"]["conv1"]["w"].transpose(2, 1, 0))


def test_seeded_init_is_deterministic():
    cfg = tiny_test_config()
    a, b, c = init_state_dict(cfg, 0), init_state_dict(cfg, 0), init_state_dict(cfg, 1)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["decoder.token_emb"], c["decoder.token_emb"])
    assert torch.equal(a["encoder.blocks.0.attn_ln.weight"], torch.ones(cfg.d_model))


def test_encode_audio_matches_jax(setup):
    jcfg, params, _, model, mel = setup
    ref = np.asarray(jax_encode(params, jcfg, jnp.asarray(mel)))
    got = encode_audio(model, torch.from_numpy(mel)).numpy()
    assert got.shape == (2, 64, 64)
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)


@pytest.mark.parametrize("quantized", [False, True])
def test_cached_decode_matches_jax(setup, quantized):
    """Prefill of a left-padded prefix with a key-side self_mask, then three
    single-token steps, with fp or int8 cross-K/V."""
    jcfg, params, cfg, model, mel = setup
    jcfg = dataclasses.replace(jcfg, quantize_cross_kv=quantized)
    cfg = dataclasses.replace(cfg, quantize_cross_kv=quantized)
    model.cfg = cfg
    ids = np.array([[50256, 50256, 50360, 11, 50257], [50360, 40, 41, 42, 50257]], np.int32)
    mask = ids != 50256
    max_new, p = 3, ids.shape[1]
    pos = np.maximum(np.cumsum(mask, axis=1) - 1, 0).astype(np.int32)
    key_mask = np.concatenate([mask, np.ones((2, max_new), bool)], axis=1)

    enc = jax_encode(params, jcfg, jnp.asarray(mel))
    jkv = jax_cross_kv(params, jcfg, enc)
    jkv = jax_quantize(jkv) if quantized else jkv
    jcache = jax_init_cache(jcfg, 2, p + max_new)
    tenc = encode_audio(model, torch.from_numpy(mel))
    tkv = precompute_cross_kv(model, tenc)
    tkv = quantize_cross_kv(tkv) if quantized else tkv
    tcache = init_kv_cache(cfg, 2, p + max_new, "cpu")

    def both(tokens, offset, positions):
        nonlocal jcache, tcache
        jl, jcache = jax_decode_tokens(params, jcfg, jnp.asarray(tokens), cross_kv=jkv,
                                       cache=jcache, pos_offset=offset,
                                       token_positions=jnp.asarray(positions),
                                       self_mask=jnp.asarray(key_mask))
        tl, tcache = decode_tokens(model, torch.from_numpy(tokens), cross_kv=tkv,
                                   cache=tcache, pos_offset=offset,
                                   token_positions=torch.from_numpy(positions),
                                   self_mask=torch.from_numpy(key_mask))
        assert tl.dtype == torch.float32 and tl.shape == jl.shape
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=0)
        return np.asarray(jl)

    logits = both(ids, 0, pos)
    assert np.isfinite(logits).all()  # fully masked pad rows stay finite
    nxt, npos = logits[:, -1].argmax(-1).astype(np.int32), pos[:, -1] + 1
    for t in range(1, max_new + 1):
        logits = both(nxt[:, None], p - 1 + t, npos[:, None].astype(np.int32))
        nxt, npos = logits[:, -1].argmax(-1).astype(np.int32), npos + 1
    np.testing.assert_allclose(tcache["k"].numpy(), np.asarray(jcache["k"]), atol=ATOL, rtol=0)
