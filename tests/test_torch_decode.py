"""Port parity for the rest of greedy decoding and for language id: OpenAI's
timestamp rules, suppressed tokens, the no-speech probability, temperature
sampling, and ``resolve_start_tokens`` / ``detect_language``.

The JAX side runs its XLA paths at ``tiny_test_config``; the port runs with
the serving kernel switches on, i.e. their plain versions on CPU tensors.
Tolerances (f32): timestamp-rule masks and tokens identical; summed
logprobs within 1e-4 (other summation orders over 51864 logits);
no-speech and language probabilities within 1e-5. Sampling draws are
torch's, not ``jax.random``'s, so the sampler is held by its distribution (a
chi-square test) and by seed determinism, not by its tokens."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisper_context_biasing_tpu.decode.greedy import apply_timestamp_rules as jax_ts_rules
from whisper_context_biasing_tpu.decode import decode_batch as jax_decode_batch
from whisper_context_biasing_tpu.decode import detect_language as jax_detect_language
from whisper_context_biasing_tpu.decode import greedy_decode as jax_greedy
from whisper_context_biasing_tpu.decode import resolve_start_tokens as jax_resolve
from whisper_context_biasing_tpu.models import init_params as jax_init
from whisper_context_biasing_tpu.models import tiny_test_config as jax_tiny
from whisper_context_biasing_tpu_torch.decode import (
    apply_timestamp_rules,
    decode_batch,
    detect_language,
    greedy_decode,
    pack_prefixes,
    resolve_start_tokens,
)
from whisper_context_biasing_tpu_torch.decode.greedy import NEG, sample_tokens
from whisper_context_biasing_tpu_torch.models import build_model, params_from_jax, tiny_test_config
from whisper_context_biasing_tpu_torch.tokenizer import load_tokenizer

KERNELS = dict(flash_attention=True, quantize_cross_kv=True, fused_quant_cross=True)


@pytest.fixture(scope="module")
def setup():
    tok = load_tokenizer()
    jcfg = jax_tiny(quantize_cross_kv=True)
    params = jax.tree.map(np.asarray, jax_init(jcfg, 0))
    cfg = tiny_test_config(**KERNELS)
    model = build_model(cfg, params_from_jax(params, cfg), device="cpu")
    mel = (np.random.default_rng(0).standard_normal((3, 80, 128)) * 0.5).astype(np.float32)
    return tok, jcfg, params, model, mel


# ---------------------------------------------------------------------------
# timestamp rules, row by row
# ---------------------------------------------------------------------------

def _rule_rows(tok):
    """Crafted row states (prev1, prev2, last_ts) and logits: nothing
    generated yet, a lone timestamp after text, a closed pair, text after a
    timestamp (the monotonic bound), one generated timestamp (counts as a
    pair), and a row whose timestamp mass beats every text token (the
    probability rule)."""
    tb = tok.timestamp_begin
    rng = np.random.default_rng(3)
    lg = rng.standard_normal((6, 51864)).astype(np.float32) * 2.0
    lg[5, tb:] += 6.0  # timestamp mass dominates
    prev1 = [-1, tb + 10, tb + 12, 300, tb + 4, 301]
    prev2 = [-1, 300, tb + 12, tb + 20, -1, 302]
    last_ts = [0, tb + 10, tb + 12, tb + 20, tb + 4, tb + 7]
    return lg, *(np.asarray(x, np.int32) for x in (prev1, prev2, last_ts))


@pytest.mark.parametrize("is_first,max_initial", [(True, 50), (True, None), (False, 50)],
                         ids=["first", "first_unbounded", "later"])
def test_timestamp_rules_match_jax(setup, is_first, max_initial):
    tok = setup[0]
    lg, p1, p2, lt = _rule_rows(tok)
    kw = dict(timestamp_begin=tok.timestamp_begin, eot_id=tok.eot, is_first=is_first,
              max_initial_timestamp_index=max_initial)
    want = np.asarray(jax_ts_rules(jnp.asarray(lg), jnp.asarray(p1), jnp.asarray(p2),
                                   jnp.asarray(lt), **kw))
    got = apply_timestamp_rules(torch.from_numpy(lg), *(torch.from_numpy(x).long()
                                                        for x in (p1, p2, lt)), **kw).numpy()
    np.testing.assert_array_equal(got == NEG, want == np.finfo(np.float32).min)
    np.testing.assert_array_equal(got, want)
    if not is_first:
        tb = tok.timestamp_begin
        masked = got == NEG
        assert masked[1, : tok.eot].all() and not masked[1, tb + 10]  # lone: ts or eot
        assert masked[2, tb:].all()                                     # pair: text next
        assert masked[3, tb: tb + 21].all() and not masked[3, tb + 21]  # monotonic
        assert masked[5, :tb].all()                                     # probability rule


# ---------------------------------------------------------------------------
# greedy decode with the new arguments, against JAX
# ---------------------------------------------------------------------------

def _both(setup, ids, mask, **kw):
    tok, jcfg, params, model, mel = setup
    jkw = dict(kw)
    if "sot_offset" in jkw and not isinstance(jkw["sot_offset"], int):
        jkw["sot_offset"] = jnp.asarray(jkw["sot_offset"], jnp.int32)
    ref = jax_greedy(params, jcfg, jnp.asarray(mel), jnp.asarray(ids), jnp.asarray(mask),
                     eot_id=tok.eot, **jkw)
    got = greedy_decode(model, mel, ids, mask, eot_id=tok.eot, device="cpu", **kw)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(ref.tokens))
    np.testing.assert_array_equal(got.lengths.numpy(), np.asarray(ref.lengths))
    np.testing.assert_allclose(got.sum_logprob.numpy(), np.asarray(ref.sum_logprob),
                               atol=1e-4, rtol=0)
    return got, ref


def test_suppress_and_no_speech_with_per_row_sot_offsets_match_jax(setup):
    """Rows start differently (a bare <|sot|>, a prompted <|sot|>, and
    <|sot|><|notimestamps|>), so each reads the no-speech probability at its
    own offset; the tokens greedy would pick first are suppressed."""
    tok, _, _, model, mel = setup
    prefixes = [[tok.sot], [tok.sop, 71, 72, tok.sot], [tok.sot, tok.no_timestamps]]
    ids, mask = pack_prefixes(prefixes, tok.eot)
    plain = greedy_decode(model, mel, ids, mask, max_new=4, eot_id=tok.eot, device="cpu")
    suppress = tuple(sorted(set(plain.tokens[:, :2].flatten().tolist())))
    got, ref = _both(setup, ids, mask, max_new=6, suppress_tokens=suppress,
                     no_speech_id=tok.no_speech, sot_offset=[1, 1, 2])
    assert not np.isin(got.tokens.numpy(), suppress).any()
    np.testing.assert_allclose(got.no_speech_prob.numpy(), np.asarray(ref.no_speech_prob),
                               atol=1e-5, rtol=0)
    # the offset matters: reading every row at offset 1 moves row 2's value
    one = greedy_decode(model, mel, ids, mask, max_new=1, eot_id=tok.eot,
                        no_speech_id=tok.no_speech, device="cpu")
    assert one.no_speech_prob[2] != got.no_speech_prob[2]


def test_timestamp_decode_matches_jax(setup):
    """t = 0 with the timestamp rules on: the first token is a timestamp of
    at most 1.0 s, then pairs, in the JAX package's tokens."""
    tok = setup[0]
    ids, mask = pack_prefixes([[tok.sot], [tok.sop, 90, tok.sot], [tok.sot]], tok.eot)
    got, _ = _both(setup, ids, mask, max_new=12, timestamp_begin=tok.timestamp_begin,
                   no_speech_id=tok.no_speech)
    first = got.tokens[:, 0].numpy()
    assert ((first >= tok.timestamp_begin) & (first <= tok.timestamp_begin + 50)).all()


def test_decode_batch_starts_and_notimestamps_match_jax(setup):
    tok, jcfg, params, model, mel = setup
    ctxs = [tok.encode("aspirin", add_special_tokens=False), [], [5, 6]]
    for kw in (dict(include_notimestamps=True), dict(starts=[[tok.sot], [tok.sot, 50362],
                                                             [tok.sot]])):
        ref = jax_decode_batch(params, jcfg, tok, mel, contexts=ctxs, max_new=5, **kw)
        assert decode_batch(model, tok, mel, contexts=ctxs, max_new=5, device="cpu", **kw) == ref


# ---------------------------------------------------------------------------
# temperature sampling
# ---------------------------------------------------------------------------

def test_sampler_distribution_chi_square():
    """20,000 draws from softmax(lg / 0.7) over 6 classes (one suppressed to
    the f32 minimum, as the filters leave it): Pearson's chi-square against
    the expected counts stays under 20.52, the 0.999 quantile at 5 degrees
    of freedom; the suppressed class is never drawn (the uniforms are a
    seeded generator's, as ``greedy.RowDraws`` gives them)."""
    lg = torch.tensor([1.0, 0.2, -0.5, 2.0, 0.0, NEG]).repeat(20000, 1)
    gen = torch.Generator().manual_seed(7)
    draws = sample_tokens(lg, 0.7, torch.rand(20000, generator=gen))
    counts = np.bincount(draws.numpy(), minlength=6)
    assert counts[5] == 0
    p = torch.softmax(lg[0, :5] / 0.7, dim=-1).numpy()
    expected = 20000 * p
    chi2 = float(((counts[:5] - expected) ** 2 / expected).sum())
    assert chi2 < 20.52, (counts, expected, chi2)


def test_sampling_is_seed_deterministic(setup):
    tok, _, _, model, mel = setup
    ids, mask = pack_prefixes([[tok.sot]] * 3, tok.eot)

    def run(seed):
        gen = torch.Generator().manual_seed(seed)
        return greedy_decode(model, mel, ids, mask, max_new=8, eot_id=tok.eot,
                             temperature=1.0, generator=gen, device="cpu")

    a, b, c = run(11), run(11), run(12)
    assert torch.equal(a.tokens, b.tokens) and torch.equal(a.sum_logprob, b.sum_logprob)
    assert not torch.equal(a.tokens, c.tokens)
    greedy = greedy_decode(model, mel, ids, mask, max_new=8, eot_id=tok.eot, device="cpu")
    assert not torch.equal(a.tokens, greedy.tokens)
    # the summed logprob is that of the unscaled filtered logits, as in JAX:
    # at most 0 and finite
    assert torch.isfinite(a.sum_logprob).all() and (a.sum_logprob <= 0).all()


# ---------------------------------------------------------------------------
# language id (multilingual byte-fallback tokenizer)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def multi():
    tok = load_tokenizer(multilingual=True)
    jcfg = jax_tiny(n_vocab=51865, multilingual=True)
    params = jax.tree.map(np.asarray, jax_init(jcfg, 1))
    cfg = tiny_test_config(n_vocab=51865, multilingual=True)
    model = build_model(cfg, params_from_jax(params, cfg), device="cpu")
    mel = (np.random.default_rng(2).standard_normal((2, 80, 128)) * 0.5).astype(np.float32)
    return tok, jcfg, params, model, mel


def test_detect_language_matches_jax(multi):
    tok, jcfg, params, model, mel = multi
    want = jax_detect_language(params, jcfg, tok, mel)
    got = detect_language(model, tok, mel)
    assert [lang for lang, _ in got] == [lang for lang, _ in want]
    np.testing.assert_allclose([p for _, p in got], [p for _, p in want], atol=1e-5, rtol=0)
    # from encoder states the caller already has: the same answer
    from whisper_context_biasing_tpu_torch.models import encode_audio

    enc = encode_audio(model, torch.from_numpy(mel))
    assert detect_language(model, tok, enc_out=enc) == got


@pytest.mark.parametrize("language,task", [(None, "transcribe"), ("fr", "transcribe"),
                                           ("auto", "transcribe"), (None, "translate"),
                                           ("de", "translate")])
def test_resolve_start_tokens_matches_jax(multi, language, task):
    tok, jcfg, params, model, mel = multi
    want = jax_resolve(tok, 2, language=language, task=task,
                       detect=lambda: jax_detect_language(params, jcfg, tok, mel))
    got = resolve_start_tokens(tok, 2, language=language, task=task,
                               detect=lambda: detect_language(model, tok, mel))
    assert got == want


@pytest.mark.parametrize("kwargs,match", [
    (dict(language="xx"), "unknown language"), (dict(language="transcribe"), "unknown"),
    (dict(language="auto"), "no detector"),
])
def test_resolve_start_tokens_refuses_as_jax(multi, kwargs, match):
    tok = multi[0]
    for fn in (resolve_start_tokens, jax_resolve):
        with pytest.raises(ValueError, match=match):
            fn(tok, 1, **kwargs)
    en = load_tokenizer()
    for fn in (resolve_start_tokens, jax_resolve):
        with pytest.raises(ValueError, match="multilingual"):
            fn(en, 1, language="fr")
