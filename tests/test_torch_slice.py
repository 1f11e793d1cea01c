"""Port parity for the slice as a whole: greedy decode with prompts, bias
spans and caps, token for token against the JAX package.

The JAX side runs its XLA paths (its own tests hold them equal to its
Pallas kernels); the port runs with every kernel switch on, so on the CPU
its kernel wrappers take their plain versions. Tokens and lengths must be
identical; summed logprobs agree within 1e-4 (f32, other summation orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from whisper_context_biasing_tpu.decode import decode_batch as jax_decode_batch
from whisper_context_biasing_tpu.decode import greedy_decode as jax_greedy
from whisper_context_biasing_tpu.models import init_params as jax_init
from whisper_context_biasing_tpu.models import tiny_test_config as jax_tiny
from whisper_context_biasing_tpu_torch.decode import decode_batch, greedy_decode, pack_prefixes
from whisper_context_biasing_tpu_torch.models import build_model, params_from_jax, tiny_test_config
from whisper_context_biasing_tpu_torch.tokenizer import load_tokenizer

EOT = 50256
KERNELS = dict(flash_attention=True, quantize_cross_kv=True, fused_quant_cross=True)


@pytest.fixture(scope="module")
def setup():
    jcfg = jax_tiny(quantize_cross_kv=True)
    params = jax.tree.map(np.asarray, jax_init(jcfg, 0))
    cfg = tiny_test_config(**KERNELS)
    model = build_model(cfg, params_from_jax(params, cfg), device="cpu")
    mel = np.random.default_rng(0).standard_normal((3, 80, 128)).astype(np.float32)
    return jcfg, params, model, mel


def _both(setup, ids, mask, spans, boost, caps, max_new, eot=EOT):
    jcfg, params, model, mel = setup
    ref = jax_greedy(params, jcfg, jnp.asarray(mel), jnp.asarray(ids), jnp.asarray(mask),
                     max_new=max_new, eot_id=eot,
                     bias_spans=None if spans is None else jnp.asarray(spans),
                     bias_boost=boost,
                     forced_eot_at=None if caps is None else jnp.asarray(caps, jnp.int32))
    got = greedy_decode(model, mel, ids, mask, max_new=max_new, eot_id=eot,
                        bias_spans=spans, bias_boost=boost, forced_eot_at=caps, device="cpu")
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(ref.tokens))
    np.testing.assert_array_equal(got.lengths.numpy(), np.asarray(ref.lengths))
    np.testing.assert_allclose(got.sum_logprob.numpy(), np.asarray(ref.sum_logprob),
                               atol=1e-4, rtol=0)
    return got


def test_prompted_biased_capped_decode_matches_jax(setup):
    """Prompts of unequal length (left-padded), bias spans at boost 2.0, and
    per-row caps (forced_eot_at) on two of the three rows."""
    prefixes = [[50360, 71, 72, 73, 74, 50257], [50257], [50360, 90, 50257]]
    ids, mask = pack_prefixes(prefixes, EOT)
    spans = np.full((3, 2, 3), EOT, np.int32)
    spans[:, 0, :3] = [97, 115, 112]
    spans[:, 1, :2] = [109, 101]
    got = _both(setup, ids, mask, spans, 2.0, [3, 100, 6], max_new=10)
    assert got.lengths.tolist()[0] == 3 and got.lengths.tolist()[2] == 6


def test_bias_driven_eot_matches_jax(setup):
    """Rows stop on their own: each bias span ends in the end token, so at a
    large boost the argmax (not a cap) picks it, after 1, 1 and 2 tokens.
    The end token is an ordinary id here; spans are still padded with 50256."""
    eot = 105
    ids, mask = pack_prefixes([[50257], [50360, 60, 50257], [50257]], EOT)
    spans = np.full((3, 1, 3), EOT, np.int32)
    spans[0, 0, :2] = [104, eot]
    spans[1, 0, :2] = [120, eot]
    spans[2, 0, :3] = [121, 122, eot]
    got = _both(setup, ids, mask, spans, 30.0, None, max_new=8, eot=eot)
    assert got.lengths.tolist() == [1, 1, 2]
    assert (got.tokens[:, 2:] == eot).all()  # eot-filled after finishing


def test_decode_batch_matches_jax(setup):
    jcfg, params, model, mel = setup
    tok = load_tokenizer()
    ctxs = [tok.encode("aspirin daily", add_special_tokens=False), [],
            tok.encode("bp", add_special_tokens=False)]
    spans = np.full((3, 1, 4), EOT, np.int32)
    spans[:, 0] = tok.encode("asp ", add_special_tokens=False)
    kw = dict(contexts=ctxs, max_new=7, bias_spans=spans, bias_boost=2.0, pad_to_multiple=32)
    ref = jax_decode_batch(params, jcfg, tok, mel, **kw)
    got = decode_batch(model, tok, mel, device="cpu", **kw)
    assert got == ref
