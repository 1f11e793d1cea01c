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
    forward as jax_forward,
    init_kv_cache as jax_init_cache,
    precompute_cross_kv as jax_cross_kv,
    quantize_cross_kv as jax_quantize,
)
from whisper_context_biasing_tpu_torch.models import (
    build_model,
    decode_tokens,
    encode_audio,
    forward,
    init_kv_cache,
    init_state_dict,
    params_from_jax,
    precompute_cross_kv,
    quantize_cross_kv,
    state_dict_to_jax,
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


# the full-sequence (training) decoder: f32 both sides, the flash kernels
# (JAX in interpret mode, the port's plain versions on the CPU) or the plain
# attention with the tril mask; sums in other orders over the vocab product
FULL_ATOL, FULL_RTOL = 2e-4, 1e-4


@pytest.mark.parametrize("flash", [True, False])
def test_full_sequence_decoder_matches_jax(setup, flash):
    jcfg, params, _, _, mel = setup
    over = dict(flash_attention=flash, flash_decoder_min_seq=0)
    jcfg = dataclasses.replace(jcfg, flash_interpret=True, flash_block_q=16, **over)
    cfg = tiny_test_config(**over)
    model = build_model(cfg, params_from_jax(params, cfg), device="cpu", train=True)
    ids = np.random.default_rng(5).integers(0, 50000, (2, 24)).astype(np.int32)
    ref = np.asarray(jax_forward(params, jcfg, jnp.asarray(mel), jnp.asarray(ids)))
    with torch.no_grad():
        got = forward(model, torch.from_numpy(mel), torch.from_numpy(ids))
    assert got.dtype == torch.float32 and got.shape == (2, 24, cfg.n_vocab)
    np.testing.assert_allclose(got.numpy(), ref, atol=FULL_ATOL, rtol=FULL_RTOL)


def test_full_sequence_decoder_rejects_int8_cross_kv(setup):
    _, _, cfg, model, mel = setup
    kv = quantize_cross_kv(precompute_cross_kv(model, encode_audio(model, torch.from_numpy(mel))))
    with pytest.raises(ValueError, match="decode-only"):
        decode_tokens(model, torch.zeros((2, 3), dtype=torch.long), cross_kv=kv)


def test_state_dict_to_jax_inverts_params_from_jax(setup):
    _, params, cfg, _, _ = setup
    back = state_dict_to_jax(params_from_jax(params, cfg), cfg)
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    assert jax.tree.structure(back) == jax.tree.structure(params)
    for path, leaf in flat:
        np.testing.assert_array_equal(_get(back, path), np.asarray(leaf), err_msg=str(path))


def _get(tree, path):
    for key in path:
        tree = tree[key.key]
    return tree


def test_training_model_holds_f32_masters():
    cfg = tiny_test_config(dtype="bfloat16")
    train = build_model(cfg, seed=0, device="cpu", train=True)
    serve = build_model(cfg, seed=0, device="cpu")
    assert all(p.dtype == torch.float32 and p.requires_grad for p in train.parameters())
    assert serve.decoder.blocks[0].mlp.fc1.weight.dtype == torch.bfloat16
    assert not any(p.requires_grad for p in serve.parameters())
    # cast at each use: both compute the same bf16 function
    mel = torch.from_numpy(np.random.default_rng(6).standard_normal((1, 80, 128))
                           .astype(np.float32))
    ids = torch.tensor([[50257, 11, 12]])
    with torch.no_grad():
        a, b = forward(train, mel, ids), forward(serve, mel, ids)
    torch.testing.assert_close(a, b, atol=0, rtol=0)
