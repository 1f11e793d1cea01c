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
    forward_hidden as jax_forward_hidden,
    init_kv_cache as jax_init_cache,
    precompute_cross_kv as jax_cross_kv,
    quantize_cross_kv as jax_quantize,
    quantize_decoder_weights as jax_quantize_weights,
)
from whisper_context_biasing_tpu_torch.models import (
    build_model,
    decode_tokens,
    encode_audio,
    forward,
    forward_hidden,
    init_kv_cache,
    init_state_dict,
    params_from_jax,
    precompute_cross_kv,
    quantize_cross_kv,
    quantize_decoder_weights,
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


# per-row cache offsets (speculative decoding) and per-query tree masks
# (Medusa): f32 both sides; logits, states and caches within 1e-5, or the
# cached decode's ATOL above behind int8 cross-K/V (its plain version sums
# the scaled products in another order: up to 5.2e-5 here)
ROW_ATOL = 1e-5


def _prefill_both(jparams, jcfg, model, mel, ids, mask, t_cache):
    """Both packages' cross K/V and caches after a scalar-offset prefill of
    the left-padded prefix."""
    pos = np.maximum(np.cumsum(mask, axis=1) - 1, 0).astype(np.int32)
    key_mask = np.concatenate([mask, np.ones((2, t_cache - ids.shape[1]), bool)], axis=1)
    jkv = jax_cross_kv(jparams, jcfg, jax_encode(jparams, jcfg, jnp.asarray(mel)))
    tkv = precompute_cross_kv(model, encode_audio(model, torch.from_numpy(mel)))
    if jcfg.quantize_cross_kv:
        jkv, tkv = jax_quantize(jkv), quantize_cross_kv(tkv)
    _, jcache = jax_decode_tokens(jparams, jcfg, jnp.asarray(ids), cross_kv=jkv,
                                  cache=jax_init_cache(jcfg, 2, t_cache), pos_offset=0,
                                  token_positions=jnp.asarray(pos),
                                  self_mask=jnp.asarray(key_mask))
    _, tcache = decode_tokens(model, torch.from_numpy(ids), cross_kv=tkv,
                              cache=init_kv_cache(model.cfg, 2, t_cache, "cpu"), pos_offset=0,
                              token_positions=torch.from_numpy(pos),
                              self_mask=torch.from_numpy(key_mask))
    return jkv, jcache, tkv, tcache, key_mask


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("offsets", ["rows", "last_slot", "clamped"])
def test_per_row_offsets_and_tree_mask_match_jax(setup, quantized, offsets):
    """A 3-token chunk written at per-row cache slots with a (B, S, T)
    per-query mask (query 2 cannot see query 1's slot: two sibling chains)
    and ``return_hidden``: logits, hidden states and the whole cache within
    1e-5. "last_slot" writes a row's chunk into the cache's last slots;
    "clamped" gives a start that would run past the cache, which both
    packages clamp to T - S (``lax.dynamic_update_slice``)."""
    jcfg, params, cfg, model, mel = setup
    jcfg = dataclasses.replace(jcfg, quantize_cross_kv=quantized)
    model.cfg = dataclasses.replace(cfg, quantize_cross_kv=quantized)
    ids = np.array([[50256, 50360, 11, 50257], [50360, 40, 41, 50257]], np.int32)
    mask = ids != 50256
    t_cache = 9
    jkv, jcache, tkv, tcache, key_mask = _prefill_both(params, jcfg, model, mel, ids, mask,
                                                       t_cache)
    off = {"rows": [4, 5], "last_slot": [4, t_cache - 3], "clamped": [5, t_cache - 1]}[offsets]
    off = np.array(off, np.int32)
    chunk = np.array([[7, 8, 9], [10, 11, 12]], np.int32)
    positions = np.array([[3, 4, 4], [4, 5, 5]], np.int32)
    tree = np.broadcast_to(key_mask[:, None, :], (2, 3, t_cache)).copy()
    tree[np.arange(2), 2, np.minimum(off + 1, t_cache - 1)] = False  # query 1's sibling
    jl, jcache, jh = jax_decode_tokens(params, jcfg, jnp.asarray(chunk), cross_kv=jkv,
                                       cache=jcache, pos_offset=jnp.asarray(off),
                                       token_positions=jnp.asarray(positions),
                                       self_mask=jnp.asarray(tree), return_hidden=True)
    tl, tcache, th = decode_tokens(model, torch.from_numpy(chunk), cross_kv=tkv, cache=tcache,
                                   pos_offset=torch.from_numpy(off),
                                   token_positions=torch.from_numpy(positions),
                                   self_mask=torch.from_numpy(tree), return_hidden=True)
    model.cfg = cfg
    tol = ATOL if quantized else ROW_ATOL
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=tol, rtol=0)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=tol, rtol=0)
    for name in ("k", "v"):
        np.testing.assert_allclose(tcache[name].numpy(), np.asarray(jcache[name]), atol=tol,
                                   rtol=0)


def test_per_row_default_positions_and_one_token(setup):
    """Per-row offsets without token_positions default to offset + arange
    (S = 1 here, a speculative draft step at max_new=1's single slot)."""
    jcfg, params, cfg, model, mel = setup
    ids = np.array([[50360, 11, 50257], [50360, 40, 50257]], np.int32)
    jkv, jcache, tkv, tcache, key_mask = _prefill_both(params, jcfg, model, mel, ids,
                                                       ids != 0, 4)
    off = np.array([3, 3], np.int32)
    jl, _ = jax_decode_tokens(params, jcfg, jnp.asarray([[5], [6]]), cross_kv=jkv, cache=jcache,
                              pos_offset=jnp.asarray(off), self_mask=jnp.asarray(key_mask))
    tl, _ = decode_tokens(model, torch.tensor([[5], [6]]), cross_kv=tkv, cache=tcache,
                          pos_offset=torch.from_numpy(off), self_mask=torch.from_numpy(key_mask))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ROW_ATOL, rtol=0)


def test_forward_hidden_matches_jax(setup):
    """The full-sequence forward's logits and final-LN states."""
    jcfg, params, _, _, mel = setup
    cfg = tiny_test_config()
    model = build_model(cfg, params_from_jax(params, cfg), device="cpu")
    ids = np.random.default_rng(7).integers(0, 50000, (2, 10)).astype(np.int32)
    jl, jh = jax_forward_hidden(params, jcfg, jnp.asarray(mel), jnp.asarray(ids))
    tl, th = forward_hidden(model, torch.from_numpy(mel), torch.from_numpy(ids))
    assert th.shape == (2, 10, cfg.d_model)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=ROW_ATOL, rtol=0)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=FULL_ATOL, rtol=FULL_RTOL)


def test_int8_decoder_weights_match_jax(setup):
    """``quantize_decoder_weights``: the port's int8 state equals the JAX
    package's quantized tree carried over by ``params_from_jax`` (``{"q",
    "s"}`` leaves), and the int8 model's prefill and step logits are within
    1e-5 of the JAX package's (an untied ``proj_out`` too). The alignment
    pass runs on it; a training model of int8 weights is refused."""
    from whisper_context_biasing_tpu_torch.models import alignment_matrix

    jcfg, params, _, _, mel = setup
    rng = np.random.default_rng(2)
    params = dict(params, proj_out=(rng.standard_normal((51864, 64)) * 0.02).astype(np.float32))
    qparams = jax.tree.map(np.asarray, jax_quantize_weights(params))
    cfg = tiny_test_config()
    sd = params_from_jax(qparams, cfg)
    assert sd["decoder.token_emb"].dtype == torch.int8 and sd["proj_out_scale"].shape == (
        51864, 1)
    model = quantize_decoder_weights(build_model(cfg, params_from_jax(params, cfg), device="cpu"))
    mine = model.state_dict()
    assert set(mine) == set(sd)
    for k, v in sd.items():
        torch.testing.assert_close(mine[k], v, atol=0, rtol=0, msg=k)
    ids = np.array([[50360, 11, 50257], [50257, 50257, 50257]], np.int32)
    mask = np.array([[True] * 3, [False, False, True]])
    jkv, jcache, tkv, tcache, key_mask = _prefill_both(qparams, jcfg, model, mel, ids, mask, 5)
    jl, jcache = jax_decode_tokens(qparams, jcfg, jnp.asarray([[5], [6]]), cross_kv=jkv,
                                   cache=jcache, pos_offset=3,
                                   token_positions=jnp.asarray([[2], [1]]),
                                   self_mask=jnp.asarray(key_mask))
    tl, _ = decode_tokens(model, torch.tensor([[5], [6]]), cross_kv=tkv, cache=tcache,
                          pos_offset=3, token_positions=torch.tensor([[2], [1]]),
                          self_mask=torch.from_numpy(key_mask))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ROW_ATOL, rtol=0)
    np.testing.assert_allclose(tcache["k"].numpy(), np.asarray(jcache["k"]), atol=ROW_ATOL,
                               rtol=0)
    enc = encode_audio(model, torch.from_numpy(mel))
    m = alignment_matrix(model, torch.tensor([[50257, 5, 6, 50256]] * 2), enc,
                         torch.ones(2, 2), torch.ones(2, 4), num_frames=32)
    assert m.shape == (2, 4, 32) and torch.isfinite(m).all()
    with pytest.raises(ValueError, match="decode-only"):
        build_model(cfg, sd, device="cpu", train=True)

