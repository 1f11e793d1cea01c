"""Port parity for beam search: ``beam_decode`` in its four
``early_stopping`` modes (the frozen pool and HF's "true", "false" and
"never") with bias spans, prompts, timestamp rules and the no-speech
probability; ``beam_decode_batch``; and ``evaluate_wer``'s beam route.

The JAX side runs its XLA paths at ``tiny_test_config``; the port runs with
the serving kernel switches on (int8 cross-K/V repeated across beams; on
CPU tensors the kernels' plain versions). The end token is an ordinary
vocabulary id that random weights pick often, so beams finish at different
steps and the finished-hypothesis pools fill. Tolerances (f32): tokens,
lengths and the best beam identical; scores within 1e-6 relative (about
1e-5 on the ~-50 of a 10-step score, where the f32 spacing is 3.8e-6);
no-speech probabilities within 1e-5; ``refs_and_pred.txt`` identical."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisper_context_biasing_tpu.data.collator import SpeechSeq2SeqCollator as JaxCollator
from whisper_context_biasing_tpu.decode import beam_decode as jax_beam
from whisper_context_biasing_tpu.decode import beam_decode_batch as jax_beam_batch
from whisper_context_biasing_tpu.models import init_params as jax_init
from whisper_context_biasing_tpu.models import tiny_test_config as jax_tiny
from whisper_context_biasing_tpu.train import evaluate_wer as jax_evaluate_wer
from whisper_context_biasing_tpu_torch.data.collator import SpeechSeq2SeqCollator
from whisper_context_biasing_tpu_torch.decode import (
    beam_decode,
    beam_decode_batch,
    greedy_decode,
    pack_prefixes,
)
from whisper_context_biasing_tpu_torch.decode.beam import top_k
from whisper_context_biasing_tpu_torch.models import build_model, params_from_jax, tiny_test_config
from whisper_context_biasing_tpu_torch.tokenizer import load_tokenizer
from whisper_context_biasing_tpu_torch.train import evaluate_wer

KERNELS = dict(flash_attention=True, quantize_cross_kv=True, fused_quant_cross=True)
PAD = 50256


@pytest.fixture(scope="module")
def setup():
    tok = load_tokenizer()
    jcfg = jax_tiny(quantize_cross_kv=True)
    params = jax.tree.map(np.asarray, jax_init(jcfg, 0))
    cfg = tiny_test_config(**KERNELS)
    model = build_model(cfg, params_from_jax(params, cfg), device="cpu")
    mel = (np.random.default_rng(0).standard_normal((2, 80, 128)) * 0.5).astype(np.float32)
    ids, mask = pack_prefixes([[tok.sop, 71, 72, 73, tok.sot], [tok.sot]], PAD)
    g = greedy_decode(model, mel, ids, mask, max_new=3, eot_id=PAD, device="cpu")
    spans = np.full((2, 2, 3), PAD, np.int32)
    word = tok.encode("asp", add_special_tokens=False)[:3]
    spans[:, 0, : len(word)] = word
    spans[:, 1, :2] = [int(g.tokens[1, 0]), int(g.tokens[1, 1])]  # a span the model likes
    # the end token: the text token the beams below emit most often
    b = beam_decode(model, mel, ids, mask, num_beams=3, max_new=10, eot_id=PAD,
                    bias_spans=spans, bias_boost=1.5, timestamp_begin=tok.timestamp_begin,
                    max_initial_timestamp_index=None, device="cpu")
    text = [t for t in b.tokens.flatten().tolist() if t < tok.timestamp_begin]
    eot = max(set(text), key=text.count)
    return tok, jcfg, params, model, mel, ids, mask, spans, eot


@pytest.mark.parametrize("mode", ["off", "true", "false", "never"])
def test_beam_decode_matches_jax(setup, mode):
    tok, jcfg, params, model, mel, ids, mask, spans, eot = setup
    kw = dict(num_beams=3, max_new=10, eot_id=eot, bias_boost=1.5, span_pad_id=PAD,
              early_stopping=mode, no_speech_id=tok.no_speech, sot_offset=1,
              timestamp_begin=tok.timestamp_begin, max_initial_timestamp_index=None)
    ref = jax_beam(params, jcfg, jnp.asarray(mel), jnp.asarray(ids), jnp.asarray(mask),
                   bias_spans=jnp.asarray(spans), **kw)
    got = beam_decode(model, mel, ids, mask, bias_spans=spans, device="cpu", **kw)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(ref.tokens))
    np.testing.assert_array_equal(got.lengths.numpy(), np.asarray(ref.lengths))
    np.testing.assert_array_equal(got.best.numpy(), np.asarray(ref.best))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(ref.scores), rtol=1e-6, atol=0)
    np.testing.assert_allclose(got.no_speech_prob.numpy(), np.asarray(ref.no_speech_prob),
                               atol=1e-5, rtol=0)
    # beams finished early: the end token shows up inside the window
    assert (got.tokens.numpy() == eot).any()


def test_beam_decode_without_timestamps_matches_jax(setup):
    """The frozen pool with plain text decoding and no bias: tokens and the
    best beam identical, and beam 1 equals greedy."""
    tok, jcfg, params, model, mel, ids, mask, _, eot = setup
    for k in (1, 4):
        ref = jax_beam(params, jcfg, jnp.asarray(mel), jnp.asarray(ids), jnp.asarray(mask),
                       num_beams=k, max_new=8, eot_id=eot)
        got = beam_decode(model, mel, ids, mask, num_beams=k, max_new=8, eot_id=eot,
                          device="cpu")
        np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(ref.tokens))
        np.testing.assert_array_equal(got.best.numpy(), np.asarray(ref.best))
    g = greedy_decode(model, mel, ids, mask, max_new=8, eot_id=eot, device="cpu")
    one = beam_decode(model, mel, ids, mask, num_beams=1, max_new=8, eot_id=eot, device="cpu")
    assert torch.equal(one.best, g.tokens)


def test_top_k_breaks_ties_as_lax():
    """Equal values: the lower index first, as jax.lax.top_k orders them."""
    x = np.array([[1.0, 3.0, 3.0, -2.0, 3.0, -1e9, -1e9, 0.0, -0.5, -2.0]], np.float32)
    for k in (1, 3, 4, 7, 10):
        v, i = top_k(torch.from_numpy(x), k)
        jv, ji = jax.lax.top_k(jnp.asarray(x), k)
        np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(v.numpy(), np.asarray(jv))


def test_beam_decode_batch_matches_jax(setup):
    tok, jcfg, params, model, mel, *_ = setup
    ctxs = [tok.encode("aspirin daily", add_special_tokens=False), []]
    for kw in (dict(contexts=ctxs), dict(starts=[[tok.sot, 50362], [tok.sot]],
                                         early_stopping="true")):
        ref = jax_beam_batch(params, jcfg, tok, mel, num_beams=2, max_new=6, **kw)
        assert beam_decode_batch(model, tok, mel, num_beams=2, max_new=6, device="cpu",
                                 **kw) == ref


def test_evaluate_wer_beam_matches_jax(setup, tmp_path):
    """evaluate_wer(num_beams=3): the same refs_and_pred.txt and WER as JAX
    (5 items in batches of 2: the trailing partial batch is padded)."""
    tok, jcfg, params, model, *_ = setup
    rng = np.random.default_rng(4)
    items = [{"input_features": (rng.standard_normal((80, 128)) * 0.4).astype(np.float32),
              "labels": np.asarray([tok.sot, 5 + i, 6, tok.eot], np.int32),
              "bias_spans": []} for i in range(5)]
    files, wers = [], []
    for pkg, coll_cls in (("jax", JaxCollator), ("port", SpeechSeq2SeqCollator)):
        coll = coll_cls(pad_token_id=tok.pad_token_id, decoder_start_token_id=tok.sot,
                        bias_span_pad_id=tok.eot)
        out = tmp_path / f"{pkg}.txt"
        if pkg == "jax":
            res = jax_evaluate_wer(params, jcfg, tok, items, coll, 2, 5,
                                   refs_pred_file=str(out), num_beams=3, num_workers=1)
        else:
            res = evaluate_wer(model, tok, items, coll, 2, 5, refs_pred_file=str(out),
                               num_beams=3, num_workers=1)
        files.append(out.read_text())
        wers.append(res["wer"])
    assert files[0] == files[1] and files[0].count("Ref :") == 5
    assert wers[0] == wers[1]
