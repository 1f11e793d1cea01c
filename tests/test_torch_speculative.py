"""Port parity for speculative greedy decoding: ``speculative_greedy_decode``
against the JAX package's and against the port's own ``greedy_decode``, in
the cases of the JAX package's ``tests/test_speculative.py`` (by name): a
random draft at k = 1 and 4, a self-draft, ragged prompts, bias-boosted
decoding, eot termination, the logprob and no-speech signals, the verify
rounds, ``max_new=1``, a draft with a smaller text context and the
multilingual ``span_pad_id``; then long-form and chunked with a draft, and
``t0_verified_decode``'s dispatch.

Both packages run ``tiny_test_config`` with int8 cross-K/V (the port with
the serving kernel switches on: their plain versions on CPU tensors). The
end token of the eot case is a text token the target emits often, so rows
stop at different rounds. Tolerances (f32): tokens, lengths and
``spec_rounds`` identical; ``no_speech_prob`` within 1e-5; ``sum_logprob``
within 1e-5 or 1e-6 relative (a sum of ~10 logprobs near -10 each, added in
per-round chunks here and per step by greedy: the f32 spacing at -100 is
7.6e-6)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from whisper_context_biasing_tpu.decode.speculative import (
    speculative_decode_batch as jax_spec_batch,
)
from whisper_context_biasing_tpu.decode.speculative import (
    speculative_greedy_decode as jax_spec,
)
from whisper_context_biasing_tpu.models import init_params as jax_init
from whisper_context_biasing_tpu.models import tiny_test_config as jax_tiny
from whisper_context_biasing_tpu_torch.decode import (
    decode_batch,
    greedy_decode,
    pack_prefixes,
    speculative_decode_batch,
    speculative_greedy_decode,
    t0_verified_decode,
)
from whisper_context_biasing_tpu_torch.decode.speculative import drafted_pad, load_draft
from whisper_context_biasing_tpu_torch.models import build_model, params_from_jax, tiny_test_config

EOT = 50256
Q = dict(quantize_cross_kv=True)
KERNELS = dict(flash_attention=True, fused_quant_cross=True)
DRAFT = dict(n_audio_layers=1, n_text_layers=1, d_model=32, n_heads=2)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for these tiny tensors: the test workers run side
    by side, and more threads a worker only contend for the cores."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(seed, **cfg_kw):
    """(JAX cfg, JAX params as numpy, the port's model) at one config."""
    jcfg = jax_tiny(**Q, **cfg_kw)
    params = jax.tree.map(np.asarray, jax_init(jcfg, seed))
    cfg = tiny_test_config(**Q, **KERNELS, **cfg_kw)
    return jcfg, params, build_model(cfg, params_from_jax(params, cfg), device="cpu")


@pytest.fixture(scope="module")
def setup():
    target = _pair(0)
    draft = _pair(7, **DRAFT)
    mel = (np.random.default_rng(0).standard_normal((3, 80, 128)) * 0.5).astype(np.float32)
    ids, mask = pack_prefixes([[50257]] * 3, EOT)
    g = greedy_decode(target[2], mel, ids, mask, max_new=12, device="cpu")
    eot = int(g.tokens[0, 4])  # a text token the target emits: rows stop at it
    return target, draft, mel, eot


def _spans():
    span = np.full((3, 2, 3), EOT, np.int32)
    span[0, 0] = [123, 456, 789]
    span[2, 0, :2] = [77, 88]
    return span


# name -> (prefixes, decode kwargs, which draft); names are the JAX tests'
CASES = {
    "random_draft_bit_matches_target_greedy-k1": ([[50257]] * 3, dict(k=1, max_new=10), "d"),
    "random_draft_bit_matches_target_greedy-k4": ([[50257]] * 3, dict(k=4, max_new=10), "d"),
    "self_draft_full_acceptance": ([[50257]] * 3, dict(k=4, max_new=12), "self"),
    "ragged_prompts": ([[50360, 11, 22, 50257], [50257], [50360, 5, 50257]],
                       dict(k=3, max_new=8), "d"),
    "bias_boost_exactness": ([[50360, 123, 50257], [50257], [50257]],
                             dict(k=3, max_new=8, bias=3.0), "d"),
    "eot_termination_matches": ([[50257]] * 3, dict(k=4, max_new=20, eot=True), "d"),
    "sum_logprob_and_no_speech_parity": ([[50257]] * 3,
                                         dict(k=3, max_new=8, no_speech_id=50361), "d"),
    "max_new_one": ([[50257]] * 3, dict(k=2, max_new=1), "d"),
    "draft_with_smaller_text_ctx": ([[50360, 11, 50257]] * 3, dict(k=3, max_new=12), "ctx8"),
}


@pytest.mark.parametrize("name", list(CASES))
def test_speculative_matches_jax_and_greedy(setup, name):
    (jcfg, jparams, model), (dcfg, dparams, dmodel), mel, eot = setup
    prefixes, kw, which = CASES[name]
    kw = dict(kw)
    if which == "self":
        dcfg, dparams, dmodel = jcfg, jparams, model
    elif which == "ctx8":  # p + max_new = 15 > the draft's 8 positions
        dcfg, dparams, dmodel = _pair(11, n_text_ctx=8, **DRAFT)
    ids, mask = pack_prefixes(prefixes, EOT)
    common = dict(max_new=kw.pop("max_new"), eot_id=eot if kw.pop("eot", False) else EOT,
                  no_speech_id=kw.pop("no_speech_id", None))
    boost = kw.pop("bias", 0.0)
    if boost:
        common.update(bias_spans=_spans(), bias_boost=boost)
    k = kw.pop("k")
    jax_kw = dict(common, bias_spans=None if not boost else jnp.asarray(_spans()))
    ref = jax_spec(dparams, dcfg, jparams, jcfg, jnp.asarray(mel), jnp.asarray(ids),
                   jnp.asarray(mask), k=k, **jax_kw)
    got = speculative_greedy_decode(dmodel, model, mel, ids, mask, k=k, device="cpu", **common)
    plain = greedy_decode(model, mel, ids, mask, device="cpu", **common)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(ref.tokens))
    np.testing.assert_array_equal(got.lengths.numpy(), np.asarray(ref.lengths))
    assert got.spec_rounds == int(ref.spec_rounds)
    np.testing.assert_array_equal(got.tokens.numpy(), plain.tokens.numpy())
    np.testing.assert_array_equal(got.lengths.numpy(), plain.lengths.numpy())
    np.testing.assert_allclose(got.sum_logprob.numpy(), np.asarray(ref.sum_logprob),
                               atol=1e-5, rtol=1e-6)
    np.testing.assert_allclose(got.sum_logprob.numpy(), plain.sum_logprob.numpy(),
                               atol=1e-5, rtol=1e-6)
    if common["no_speech_id"] is not None:
        np.testing.assert_allclose(got.no_speech_prob.numpy(), np.asarray(ref.no_speech_prob),
                                   atol=1e-5, rtol=0)
    if name == "self_draft_full_acceptance":
        # every round accepts all k drafts: ceil((12 - 1) / (k + 1)) rounds
        assert got.spec_rounds == -(-11 // 5)
    if name == "eot_termination_matches":
        assert int(got.lengths.min()) < 20, "the end token never stopped a row"


def test_spec_rounds_reflect_acceptance(setup):
    """A self-draft finishes in fewer verify rounds than a random one."""
    (jcfg, jparams, model), (dcfg, dparams, dmodel), mel, _ = setup
    ids, mask = pack_prefixes([[50257]] * 3, EOT)
    fast = speculative_greedy_decode(model, model, mel, ids, mask, k=4, max_new=12, device="cpu")
    slow = speculative_greedy_decode(dmodel, model, mel, ids, mask, k=4, max_new=12,
                                     device="cpu")
    assert fast.spec_rounds < slow.spec_rounds
    assert fast.spec_rounds <= -(-11 // 5) + 1


def test_multilingual_span_pad_id_parity():
    """``speculative_decode_batch`` threads ``span_pad_id=tokenizer.eot``
    (50257 on the multilingual vocabulary) like ``decode_batch``: the same
    lists as the port's decode_batch and the JAX package's wrapper."""
    from whisper_context_biasing_tpu.tokenizer import load_tokenizer as jax_tokenizer
    from whisper_context_biasing_tpu_torch.tokenizer import load_tokenizer

    tok = load_tokenizer(multilingual=True)
    jcfg, jparams, model = _pair(0, n_vocab=51866)
    dcfg, dparams, dmodel = _pair(7, n_vocab=51866, **DRAFT)
    mel = (np.random.default_rng(1).standard_normal((2, 80, 128)) * 0.5).astype(np.float32)
    span = np.full((2, 2, 3), tok.eot, np.int32)
    span[0, 0] = [123, 456, 789]
    span[1, 0, :1] = [321]
    kw = dict(max_new=8, bias_spans=span, bias_boost=4.0)
    want = jax_spec_batch(dparams, dcfg, jparams, jcfg, jax_tokenizer(multilingual=True), mel,
                          k=3, **kw)
    got = speculative_decode_batch(dmodel, model, tok, mel, k=3, device="cpu", **kw)
    assert got == want == decode_batch(model, tok, mel, device="cpu", **kw)


def test_t0_verified_decode_dispatch(setup):
    """No accelerator runs plain greedy; a draft runs the speculative loop;
    the same tokens either way."""
    (_, _, model), (dcfg, _, dmodel), mel, _ = setup
    from whisper_context_biasing_tpu_torch.tokenizer import load_tokenizer

    tok = load_tokenizer()
    ids, mask = pack_prefixes([[tok.sot]] * 3, tok.eot)
    plain = t0_verified_decode(model, tok, mel, ids, mask, max_new=6, device="cpu")
    spec = t0_verified_decode(model, tok, mel, ids, mask, max_new=6, device="cpu",
                              draft=(dmodel, dcfg, 2))
    assert plain.spec_rounds is None and spec.spec_rounds >= 1
    np.testing.assert_array_equal(plain.tokens.numpy(), spec.tokens.numpy())


def test_drafted_pad_and_load_draft(capsys):
    """``drafted_pad`` is [d1..dk, the write-only step's token]; ``load_draft``
    keeps the kernel overrides only, warns for random weights and refuses
    another vocabulary."""
    import torch

    ds = torch.arange(12).reshape(2, 6)
    np.testing.assert_array_equal(drafted_pad(ds, 4).numpy(), ds[:, 1:6].numpy())
    model, cfg = load_draft("tiny.en", overrides={"flash_attention": True, "dtype": "x",
                                                  "n_text_layers": 1}, dtype="float32",
                            device="cpu")
    assert cfg.flash_attention and cfg.n_text_layers == 4 and cfg.dtype == "float32"
    assert next(model.parameters()).dtype == torch.float32
    assert "random draft weights" in capsys.readouterr().err
    with pytest.raises(ValueError, match="vocab"):
        load_draft("tiny", target_cfg=cfg, device="cpu")


def long_form_runs(model, jcfg, jparams, seed, **accel):
    """The port's sequential and chunked long-form with ``accel`` (a draft
    or Medusa heads) at t=0, the port's plain runs and the JAX package's
    plain runs, on a 1.5-window and a half-window clip of noise (the
    reduced test window): {route: (accelerated, plain, JAX plain)}."""
    from whisper_context_biasing_tpu.audio.mel import log_mel_spectrogram_np as jax_mel
    from whisper_context_biasing_tpu.decode import transcribe_chunked as jax_chunked
    from whisper_context_biasing_tpu.decode import transcribe_long_batch as jax_long
    from whisper_context_biasing_tpu.tokenizer import load_tokenizer as jax_tokenizer
    from whisper_context_biasing_tpu_torch.audio import log_mel_spectrogram_np
    from whisper_context_biasing_tpu_torch.decode import transcribe_chunked, transcribe_long_batch
    from whisper_context_biasing_tpu_torch.tokenizer import load_tokenizer

    tok, jtok = load_tokenizer(), jax_tokenizer()
    win = jcfg.n_audio_ctx * 320
    rng = np.random.default_rng(seed)
    audios = [rng.standard_normal(int(win * 1.6)).astype(np.float32) * 0.1,
              rng.standard_normal(win // 2).astype(np.float32) * 0.1]
    frames = 2 * jcfg.n_audio_ctx
    kw = dict(max_new=6, temperatures=(0.0,), no_speech_threshold=None, logprob_threshold=None,
              compression_ratio_threshold=None, window_samples=win, use_timestamps=False)
    out = {}
    for route, port_fn, jax_fn in (("long", transcribe_long_batch, jax_long),
                                   ("chunked", transcribe_chunked, jax_chunked)):
        mel_fn = lambda b: np.stack([log_mel_spectrogram_np(a)[:, :frames] for a in b])  # noqa
        jmel_fn = lambda b: np.stack([jax_mel(a)[:, :frames] for a in b])  # noqa: E731
        out[route] = (port_fn(model, tok, audios, mel_fn=mel_fn, device="cpu", **accel, **kw),
                      port_fn(model, tok, audios, mel_fn=mel_fn, device="cpu", **kw),
                      jax_fn(jparams, jcfg, jtok, audios, mel_fn=jmel_fn, **kw))
    return out


def test_long_form_and_chunked_draft_match_plain(setup):
    """``transcribe_long_batch(draft=...)`` and ``transcribe_chunked(draft=...)``
    give the plain loops' tokens (the JAX package's ``test_long_form_draft_
    matches_plain`` and ``test_chunked_draft_matches_plain``), which are the
    JAX package's plain tokens."""
    (jcfg, jparams, model), (dcfg, _, dmodel), _, _ = setup
    for route, (got, plain, want) in long_form_runs(model, jcfg, jparams, 3,
                                                    draft=(dmodel, dmodel.cfg, 3)).items():
        assert got == plain == want, route
