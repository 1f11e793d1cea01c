"""Port parity: the training layer vs the JAX package in f32.

WeightCE and its span weights, the clipped AdamW and its schedule against
optax, and one ``make_train_step`` from identical weights (the JAX init,
carried over with ``params_from_jax``) with the flash kernels on: JAX runs
its Pallas forward and backward in interpret mode, the port its plain
versions (CPU tensors). Gradients and post-step weights are compared in the
JAX layout through ``state_dict_to_jax``."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from whisper_context_biasing_tpu.models import init_params as jax_init
from whisper_context_biasing_tpu.models import tiny_test_config as jax_tiny
from whisper_context_biasing_tpu.train import bias_span_weights as jax_span_weights
from whisper_context_biasing_tpu.train import init_train_state as jax_init_state
from whisper_context_biasing_tpu.train import make_optimizer as jax_make_optimizer
from whisper_context_biasing_tpu.train import make_train_step as jax_make_step
from whisper_context_biasing_tpu.train import warmup_cosine_schedule as jax_schedule
from whisper_context_biasing_tpu.train import weighted_ce_loss as jax_weighted_ce
from whisper_context_biasing_tpu.train.step import (
    accumulate_microbatch_grads as jax_accumulate,
    make_loss_fn as jax_make_loss_fn,
)
from whisper_context_biasing_tpu_torch.audio import log_mel_spectrogram
from whisper_context_biasing_tpu_torch.data.collator import SpeechSeq2SeqCollator
from whisper_context_biasing_tpu_torch.models import (
    build_model,
    params_from_jax,
    state_dict_to_jax,
    tiny_test_config,
)
from whisper_context_biasing_tpu_torch.train import (
    accumulate_microbatch_grads,
    bias_span_weights,
    init_train_state,
    make_eval_loss_step,
    make_loss_fn,
    make_optimizer,
    make_train_step,
    warmup_cosine_schedule,
    weighted_ce_loss,
)

PAD = 50256

# ---------------------------------------------------------------------------
# WeightCE
# ---------------------------------------------------------------------------


def _random_spans(seed, b=3, s=30, v=50304, n=4, k=3):
    """Labels with ignored positions, spans with random padding, some planted
    in the labels so that matches occur (the JAX package's own test data)."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(-1, 60, (b, s)).astype(np.int32)
    labels[labels < 0] = -100
    spans = rng.integers(0, 60, (b, n, k)).astype(np.int32)
    for i in range(b):
        for j in range(n):
            spans[i, j, rng.integers(0, k + 1):] = PAD
    for i in range(b):
        n_tok = int(np.sum(spans[i, 0] != PAD))
        if n_tok:
            labels[i, 2 : 2 + n_tok] = spans[i, 0, :n_tok]
            labels[i, 20 : 20 + n_tok] = spans[i, 0, :n_tok]
    labels[0, 25:28] = [50257, 50256, 7]  # specials are never upweighted
    spans[0, 1] = [50257, 50256, 7]
    logits = rng.standard_normal((b, s, v)).astype(np.float32)  # v covers the specials
    return logits, labels, spans


@pytest.mark.parametrize("seed", [1, 2, 3, 4])
def test_bias_span_weights_match_jax(seed):
    _, labels, spans = _random_spans(seed)
    ref = np.asarray(jax_span_weights(jnp.asarray(labels), jnp.asarray(spans), 1.5))
    got = bias_span_weights(torch.from_numpy(labels), torch.from_numpy(spans), 1.5)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), ref)
    assert (ref == 1.5).any()  # the data does exercise matches


# f32 log-softmax on both sides, summed in other orders
LOSS_RTOL = 1e-6


@pytest.mark.parametrize("seed", [1, 2, 3])
@pytest.mark.parametrize("with_spans", [True, False])
def test_weighted_ce_matches_jax(seed, with_spans):
    logits, labels, spans = _random_spans(seed)
    jspans = jnp.asarray(spans) if with_spans else None
    ref = float(jax_weighted_ce(jnp.asarray(logits), jnp.asarray(labels), jspans, 2.5))
    got = weighted_ce_loss(torch.from_numpy(logits), torch.from_numpy(labels),
                           torch.from_numpy(spans) if with_spans else None, 2.5)
    assert got.ndim == 0
    assert float(got) == pytest.approx(ref, rel=LOSS_RTOL)


def test_all_pad_spans_equal_plain_ce():
    logits, labels, _ = _random_spans(5)
    t = torch.from_numpy
    plain = weighted_ce_loss(t(logits), t(labels))
    padded = weighted_ce_loss(t(logits), t(labels), t(np.full((3, 2, 3), PAD, np.int32)))
    assert float(plain) == pytest.approx(float(padded), rel=1e-6)


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------


# optax evaluates the schedule in f32 (its cosine is off by up to ~2e-6
# relative, more near the end of the decay where 1 + cos cancels); the port
# evaluates it in double. Limit: 1e-5 of the peak
SCHEDULE_ATOL = 1e-5 * 1e-3


def test_schedule_matches_optax():
    for warmup, total in ((3, 8), (0, 5), (50, 1000)):
        ref, got = jax_schedule(1e-3, warmup, total), warmup_cosine_schedule(1e-3, warmup, total)
        for count in list(range(12)) + [499, 999, 1000, 1500]:
            assert got(count) == pytest.approx(float(ref(count)), rel=0, abs=SCHEDULE_ATOL)


# f32 updates with roundings in other places (the schedule above, the order
# of the moment updates); weights of realistic size (~0.05, as a
# 1/sqrt(fan_in) init), where 1e-7 is ~25 f32 ulps
OPT_ATOL = 1e-7


def test_optimizer_matches_optax():
    """Identical gradients through warmup and cosine steps; the gradient
    scale moves across the clip threshold (global norm 1.0) both ways."""
    rng = np.random.default_rng(0)
    shapes = {"w": (6, 5), "b": (5,), "ln": (7,)}
    params = {k: (rng.standard_normal(s) * 0.05).astype(np.float32)
              for k, s in shapes.items()}
    kw = dict(peak_lr=1e-3, warmup_steps=3, total_steps=8, weight_decay=0.1)
    jopt, opt = jax_make_optimizer(**kw), make_optimizer(**kw)
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = jopt.init(jparams)
    tparams = [torch.from_numpy(params[k].copy()) for k in shapes]
    state = opt.init(tparams)
    for step, scale in enumerate([0.01, 3.0, 0.05, 10.0, 0.2, 1.0, 0.03, 5.0]):
        grads = {k: (rng.standard_normal(s) * scale).astype(np.float32)
                 for k, s in shapes.items()}
        upd, jstate = jopt.update({k: jnp.asarray(v) for k, v in grads.items()}, jstate,
                                  jparams)
        jparams = optax.apply_updates(jparams, upd)
        opt.update_(tparams, [torch.from_numpy(grads[k]) for k in shapes], state)
        for k, p in zip(shapes, tparams):
            np.testing.assert_allclose(p.numpy(), np.asarray(jparams[k]), atol=OPT_ATOL,
                                       rtol=0, err_msg=f"{k} after step {step}")
    assert state.count == 8


# ---------------------------------------------------------------------------
# the training step
# ---------------------------------------------------------------------------

LR = 1e-3
ACCUM = 2
# f32 both sides; losses of ~10 summed in other orders
STEP_LOSS_RTOL = 1e-5
# gradients through 2+2 layers and the flash backward, f32, other orders
GRAD_ATOL = 1e-5
# post-step weights: Adam's first step moves each weight by ~lr
PARAM_ATOL = 0.1 * LR


def _collated_batch(seed, rows=4, label_len=24):
    """Prompted label rows (<|startofprev|> context <|startoftranscript|>
    text <|endoftext|>) with bias spans planted in the text, through the
    port's collator; then split into ACCUM microbatches."""
    rng = np.random.default_rng(seed)
    feats = []
    for i in range(rows):
        ctx = list(rng.integers(100, 5000, 3 + i))
        text = list(rng.integers(100, 5000, label_len - len(ctx) - 3 - i))
        span = text[2 : 4 + i % 2]
        feats.append({
            "input_features": (rng.standard_normal((80, 128)) * 0.5).astype(np.float32),
            "labels": [50360, *ctx, 50257, *text, 50256],
            "bias_spans": [span, list(rng.integers(100, 5000, 2))],
        })
    coll = SpeechSeq2SeqCollator(pad_token_id=PAD, decoder_start_token_id=50257,
                                 decoder_prev_token_id=50360, max_target_length=label_len)
    batch = coll(feats)
    return {k: v.reshape(ACCUM, rows // ACCUM, *v.shape[1:]) for k, v in batch.items()}


@pytest.fixture(scope="module")
def one_step():
    """One step from the same weights and batch in both packages."""
    over = dict(flash_attention=True, flash_decoder_min_seq=0)
    jcfg = jax_tiny(flash_interpret=True, flash_block_q=16, **over)
    params = jax.tree.map(np.asarray, jax_init(jcfg, 0))
    batch = _collated_batch(0)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    kw = dict(peak_lr=LR, warmup_steps=0, total_steps=100)

    jopt = jax_make_optimizer(**kw)
    jstep = jax_make_step(jcfg, jopt, bias_weight=1.5, grad_accum=ACCUM, donate=False)
    jstate, jm = jstep(jax_init_state(params, jopt), jbatch)
    grad_fn = jax.value_and_grad(jax_make_loss_fn(jcfg, 1.5))
    _, jgrads = jax.jit(lambda p, b: jax_accumulate(lambda mb: grad_fn(p, mb), p, b, ACCUM))(
        params, jbatch)

    cfg = tiny_test_config(**over)
    model = build_model(cfg, params_from_jax(params, cfg), device="cpu", train=True)
    opt = make_optimizer(**kw)
    step = make_train_step(cfg, opt, bias_weight=1.5, grad_accum=ACCUM)
    state, m = step(init_train_state(model, opt), batch)
    grads = {n: p.grad for n, p in model.named_parameters()}
    return dict(jm=jm, jparams=jstate.params, jgrads=jgrads, m=m, state=state,
                params=state_dict_to_jax(dict(model.named_parameters()), cfg),
                grads=state_dict_to_jax(grads, cfg))


def _leaves(tree):
    return jax.tree_util.tree_flatten_with_path(tree)[0]


def test_train_step_loss_and_grad_norm_match_jax(one_step):
    assert float(one_step["m"]["loss"]) == pytest.approx(float(one_step["jm"]["loss"]),
                                                         rel=STEP_LOSS_RTOL)
    assert float(one_step["m"]["grad_norm"]) == pytest.approx(
        float(one_step["jm"]["grad_norm"]), rel=STEP_LOSS_RTOL)
    assert one_step["state"].step == 1 and one_step["state"].opt_state.count == 1


@pytest.mark.parametrize("part", ["encoder", "decoder"])
def test_train_step_grads_match_jax(one_step, part):
    want = dict(_leaves(one_step["jgrads"][part]))
    for path, got in _leaves(one_step["grads"][part]):
        np.testing.assert_allclose(got, np.asarray(want[path]), atol=GRAD_ATOL, rtol=0,
                                   err_msg=f"{part}{jax.tree_util.keystr(path)}")


@pytest.mark.parametrize("part", ["encoder", "decoder"])
def test_train_step_params_match_jax(one_step, part):
    want = dict(_leaves(one_step["jparams"][part]))
    for path, got in _leaves(one_step["params"][part]):
        np.testing.assert_allclose(got, np.asarray(want[path]), atol=PARAM_ATOL, rtol=0,
                                   err_msg=f"{part}{jax.tree_util.keystr(path)}")


def _tiny_model(**over):
    cfg = tiny_test_config(flash_attention=True, flash_decoder_min_seq=0, **over)
    return cfg, build_model(cfg, seed=0, device="cpu", train=True)


def test_freeze_encoder_moves_only_the_decoder():
    """Encoder weights stay bit-identical (no gradient, no weight decay); the
    decoder moves exactly as it does when full gradients are computed and
    the encoder's are discarded before the optimizer."""
    batch = _collated_batch(1)
    cfg, model = _tiny_model()
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    opt = make_optimizer(peak_lr=LR, warmup_steps=0, total_steps=100)
    step = make_train_step(cfg, opt, grad_accum=ACCUM, freeze_encoder=True)
    state, m = step(init_train_state(model, opt), batch)

    _, ref = _tiny_model()
    ref_state = init_train_state(ref, opt)
    batch_t = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss, grads = accumulate_microbatch_grads(make_loss_fn(cfg, 1.5), ref, batch_t, ACCUM)
    names = [n for n, _ in ref.named_parameters()]
    enc = [i for i, n in enumerate(names) if n.startswith("encoder.")]
    grads = [None if i in enc else g for i, g in enumerate(grads)]
    opt.update_(ref.parameters(), grads, ref_state.opt_state, frozen=enc)

    assert float(m["loss"]) == pytest.approx(float(loss), rel=1e-6)
    for (n, p), r in zip(model.named_parameters(), ref.parameters()):
        if n.startswith("encoder."):
            assert torch.equal(p, before[n]), n
            assert p.grad is None, n
        else:
            torch.testing.assert_close(p, r, atol=1e-6, rtol=0, msg=n)
    assert not torch.equal(model.decoder.ln.weight, before["decoder.ln.weight"])


def test_mel_on_device_matches_precomputed_features():
    """Raw audio through the mel frontend inside the step gives the loss of
    the same audio's features computed beforehand."""
    rng = np.random.default_rng(2)
    batch = _collated_batch(2)
    audio = (rng.standard_normal((ACCUM, 2, 128 * 160)) * 0.1).astype(np.float32)
    batch["input_features"] = log_mel_spectrogram(torch.from_numpy(audio).flatten(0, 1)) \
        .view(ACCUM, 2, 80, 128).numpy()
    raw = dict({k: v for k, v in batch.items() if k != "input_features"}, audio=audio)
    losses = []
    for mel_on_device, b in ((False, batch), (True, raw)):
        cfg, model = _tiny_model()
        opt = make_optimizer(peak_lr=LR, warmup_steps=0, total_steps=100)
        step = make_train_step(cfg, opt, grad_accum=ACCUM, mel_on_device=mel_on_device)
        _, m = step(init_train_state(model, opt), b)
        losses.append(float(m["loss"]))
    assert losses[0] == pytest.approx(losses[1], rel=1e-6)


def test_remat_none_matches_full():
    batch = {k: torch.from_numpy(v) for k, v in _collated_batch(3).items()}
    out = []
    for remat in ("full", "none"):
        cfg, model = _tiny_model(remat=remat)
        out.append(accumulate_microbatch_grads(make_loss_fn(cfg, 1.5), model, batch, ACCUM))
    assert float(out[0][0]) == pytest.approx(float(out[1][0]), rel=1e-6)
    for a, b in zip(out[0][1], out[1][1]):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=0)


def test_eval_loss_step_matches_the_loss():
    batch = _collated_batch(4)
    mb = {k: v[0] for k, v in batch.items()}
    cfg, model = _tiny_model()
    got = make_eval_loss_step(cfg)(model, mb)
    want = make_loss_fn(cfg, 1.5)(model, {k: torch.from_numpy(v) for k, v in mb.items()})
    want = want.detach()
    assert not got.requires_grad
    assert float(got) == pytest.approx(float(want), rel=1e-6)


@pytest.mark.parametrize("option", ["spec_augment", "remat=dots", "remat=wide"])
def test_unported_training_options_raise(option):
    if option == "spec_augment":  # ported since: a bad config raises, a real one runs
        from whisper_context_biasing_tpu_torch.train import SpecAugmentConfig

        with pytest.raises(TypeError, match="SpecAugmentConfig"):
            make_train_step(tiny_test_config(), make_optimizer(), spec_augment=object())
        cfg, model = _tiny_model()
        opt = make_optimizer(peak_lr=LR, warmup_steps=0, total_steps=10)
        step = make_train_step(cfg, opt, grad_accum=ACCUM, spec_augment=SpecAugmentConfig())
        _, m = step(init_train_state(model, opt), _collated_batch(5))
        assert np.isfinite(float(m["loss"]))
        return
    # ported since: the policy runs a step, with remat="none"'s gradients
    batch = {k: torch.from_numpy(v) for k, v in _collated_batch(3).items()}
    out = []
    for remat in (option.split("=")[1], "none"):
        cfg, model = _tiny_model(remat=remat)
        out.append(accumulate_microbatch_grads(make_loss_fn(cfg, 1.5), model, batch, ACCUM))
    assert float(out[0][0]) == pytest.approx(float(out[1][0]), rel=1e-6)
    for a, b in zip(out[0][1], out[1][1]):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=0)
