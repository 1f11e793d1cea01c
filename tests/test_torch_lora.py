"""Port parity: SpecAugment (``train/augment.py``) and LoRA
(``train/lora.py``) against the JAX package in f32.

SpecAugment in two halves: applying masks is held to JAX's
``apply_spec_augment`` when it is given the masks JAX's ``_axis_masks``
drew for the key (the same cells filled, every other cell bit-equal, the
fill, a row mean, within 1e-7); drawing them (a ``torch.Generator``, other numbers than
``jax.random``'s) is held by its distribution, by its determinism per
``(seed, step)`` and by the step's wiring. LoRA: the adapter tree's layout,
``merge_lora`` within 1e-6 of JAX's on carried-over adapters, the loss at
rel 1e-5 and adapter gradients at 1e-4 against JAX's (the flash kernels on:
JAX in interpret mode, the port's plain versions on CPU tensors, remat
"full", so the port's swap reaches the recomputed blocks), one optimizer
step's adapters at 1e-5, the loop over a tiny corpus from JAX's adapters
(losses at rel 1e-5; adapter checkpoints under 1/20 of the full size with
``lora_rank`` stamped; merged output in the base shapes) and ``cli.train
--lora_rank 2 --spec_augment`` on the CPU."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisper_context_biasing_tpu.models import init_params as jax_init
from whisper_context_biasing_tpu.models import tiny_test_config as jax_tiny
from whisper_context_biasing_tpu.train import TrainingConfig as JaxTrainingConfig
from whisper_context_biasing_tpu.train import init_train_state as jax_init_state
from whisper_context_biasing_tpu.train import make_optimizer as jax_make_optimizer
from whisper_context_biasing_tpu.train import train_and_evaluate as jax_train_and_evaluate
from whisper_context_biasing_tpu.train.augment import _axis_masks as jax_axis_masks
from whisper_context_biasing_tpu.train.augment import apply_spec_augment as jax_apply
from whisper_context_biasing_tpu.train.lora import init_lora_params as jax_init_lora
from whisper_context_biasing_tpu.train.lora import make_lora_train_step as jax_lora_step
from whisper_context_biasing_tpu.train.lora import merge_lora as jax_merge
from whisper_context_biasing_tpu.train.step import make_loss_fn as jax_make_loss_fn
from whisper_context_biasing_tpu.train.step import (
    accumulate_microbatch_grads as jax_accumulate,
)
from whisper_context_biasing_tpu_torch.data.collator import SpeechSeq2SeqCollator
from whisper_context_biasing_tpu_torch.models import (
    build_model,
    params_from_jax,
    state_dict_to_jax,
    tiny_test_config,
)
from whisper_context_biasing_tpu_torch.tokenizer import load_tokenizer
from whisper_context_biasing_tpu_torch.train import (
    SpecAugmentConfig,
    TrainingConfig,
    apply_spec_augment,
    init_lora_params,
    init_lora_state,
    init_train_state,
    list_checkpoints,
    lora_param_count,
    make_lora_train_step,
    make_optimizer,
    make_train_step,
    merge_lora,
    train_and_evaluate,
)
from whisper_context_biasing_tpu_torch.train import augment, lora
from whisper_context_biasing_tpu_torch.train import loop as port_loop

PAD = 50256
ACCUM = 2
LR = 1e-3


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for these tiny tensors: the test workers run side
    by side, and more threads a worker only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# SpecAugment
# ---------------------------------------------------------------------------

def _jax_masks(key, b, m, t, cfg):
    """The masks JAX's ``apply_spec_augment(feats, key, cfg)`` draws."""
    kf, kt = jax.random.split(key)
    fmask = jax_axis_masks(kf, b, m, cfg.n_freq_masks, cfg.max_freq_width)
    tmask = jax_axis_masks(kt, b, t, cfg.n_time_masks, max(1, int(t * cfg.max_time_frac)))
    return np.asarray(fmask), np.asarray(tmask)


@pytest.mark.parametrize("cfg", [
    SpecAugmentConfig(),
    SpecAugmentConfig(n_freq_masks=3, max_freq_width=10, n_time_masks=4, max_time_frac=0.2),
    SpecAugmentConfig(n_freq_masks=0, max_freq_width=0, n_time_masks=0),
], ids=["default", "wide", "off"])
def test_apply_half_equals_jax_given_its_masks(cfg):
    from whisper_context_biasing_tpu.train.augment import SpecAugmentConfig as JaxCfg

    jcfg = JaxCfg(**vars(cfg))
    feats = np.random.default_rng(0).standard_normal((4, 80, 200)).astype(np.float32)
    for seed in range(3):
        key = jax.random.PRNGKey(seed)
        want = np.asarray(jax_apply(jnp.asarray(feats), key, jcfg))
        fmask, tmask = _jax_masks(key, 4, 80, 200, jcfg)
        got = augment.apply_spec_augment_masks(torch.from_numpy(feats), torch.tensor(fmask),
                                               torch.tensor(tmask)).numpy()
        masked = fmask[:, :, None] | tmask[:, None, :]
        # JAX filled exactly these cells, and left the others as they were
        np.testing.assert_array_equal(want != feats, masked)
        np.testing.assert_array_equal(got[~masked], want[~masked])
        # the fill: each row's f32 mean of 16,000 unit-scale values, summed in
        # another order by XLA than by torch (a few 1e-9 apart)
        np.testing.assert_allclose(got[masked], want[masked], atol=1e-7, rtol=0)


def _coverage_exact(axis_len, max_width):
    """P(cell j is masked) for one run: start ~ U[0, axis_len - 1], width ~
    U[0, max_width], clipped at the axis end."""
    j = np.arange(axis_len)[:, None, None]
    s = np.arange(axis_len)[None, :, None]
    w = np.arange(max_width + 1)[None, None, :]
    hit = (j >= s) & (j < s + w)
    return hit.mean(axis=(1, 2))


@pytest.mark.parametrize("axis_len,max_width", [(80, 27), (300, 15)])
def test_draw_half_distribution(axis_len, max_width):
    """One run a row over 20,000 rows: each cell's masked frequency is the
    exact probability within 0.015 (5 sigma of 20,000 draws), as is JAX's
    own; widths recovered from unclipped runs cover 0..max_width evenly."""
    n = 20000
    g = torch.Generator().manual_seed(1)
    got = augment._axis_masks(n, axis_len, 1, max_width, g, "cpu").numpy()
    want = _coverage_exact(axis_len, max_width)
    jax_got = np.asarray(jax_axis_masks(jax.random.PRNGKey(1), n, axis_len, 1, max_width))
    assert np.abs(got.mean(axis=0) - want).max() < 0.015
    assert np.abs(jax_got.mean(axis=0) - want).max() < 0.015
    starts = np.where(got.any(axis=1), got.argmax(axis=1), -1)
    widths = got.sum(axis=1)
    inside = (starts >= 0) & (starts + max_width < axis_len)
    counts = np.bincount(widths[inside], minlength=max_width + 1)[1:]
    # width 0 leaves no run; 1..max_width equally likely
    assert counts.min() > 0.8 * counts.mean() and counts.max() < 1.2 * counts.mean()
    # starts of non-empty runs spread over the whole axis
    assert np.unique(starts[starts >= 0]).size > 0.9 * axis_len


def test_draw_half_seeded_by_seed_and_step():
    cfg = SpecAugmentConfig()
    masks = {}
    for seed, step in ((0, 0), (0, 0), (0, 1), (1, 0)):
        g = augment.step_generator(seed, step, "cpu")
        masks.setdefault((seed, step), []).append(
            [m.numpy() for m in augment.draw_spec_augment_masks(4, 80, 3000, g, cfg)])
    a, b = masks[0, 0]
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    for other in (masks[0, 1][0], masks[1, 0][0]):
        assert not all(np.array_equal(x, y) for x, y in zip(a, other))
    # masked cells carry each row's mean; a masked share in (0, 0.9)
    feats = torch.from_numpy(np.random.default_rng(0).standard_normal((4, 80, 128))
                             .astype(np.float32))
    out = apply_spec_augment(feats, torch.Generator().manual_seed(3), cfg)
    changed = (out != feats).numpy()
    assert 0.0 < changed.mean() < 0.9
    for r in range(4):
        np.testing.assert_allclose(out[r].numpy()[changed[r]], feats[r].mean().item(),
                                   rtol=1e-6)


def _collated_batch(seed, rows=4, label_len=24):
    """Prompted rows with bias spans planted in the text, through the port's
    collator, split into ACCUM microbatches (test_torch_train.py's batch)."""
    rng = np.random.default_rng(seed)
    feats = []
    for i in range(rows):
        ctx = list(rng.integers(100, 5000, 3 + i))
        text = list(rng.integers(100, 5000, label_len - len(ctx) - 3 - i))
        feats.append({
            "input_features": (rng.standard_normal((80, 128)) * 0.5).astype(np.float32),
            "labels": [50360, *ctx, 50257, *text, 50256],
            "bias_spans": [text[2: 4 + i % 2], list(rng.integers(100, 5000, 2))],
        })
    coll = SpeechSeq2SeqCollator(pad_token_id=PAD, decoder_start_token_id=50257,
                                 decoder_prev_token_id=50360, max_target_length=label_len)
    batch = coll(feats)
    return {k: v.reshape(ACCUM, rows // ACCUM, *v.shape[1:]) for k, v in batch.items()}


def test_train_step_augments_per_step():
    """The step masks with ``step_generator(augment_seed, state.step)``: its
    loss equals the unaugmented step's on the features masked by hand, and a
    second step on the same batch (new masks) gives another loss."""
    batch = _collated_batch(2)
    cfg = tiny_test_config()
    sa = SpecAugmentConfig()
    losses = []
    for spec in (sa, None):
        model = build_model(cfg, seed=0, device="cpu", train=True)
        opt = make_optimizer(peak_lr=LR, warmup_steps=0, total_steps=10)
        step = make_train_step(cfg, opt, grad_accum=ACCUM, spec_augment=spec, augment_seed=5)
        b = batch
        if spec is None:
            b = augment.make_augment_fn(sa, 5)(
                {k: torch.from_numpy(v) for k, v in batch.items()}, 0)
        state, m1 = step(init_train_state(model, opt), b)
        losses.append(float(m1["loss"]))
        if spec is not None:
            _, m2 = step(state, batch)
    assert losses[0] == pytest.approx(losses[1], rel=1e-6)
    assert float(m2["loss"]) != losses[0]


def test_spec_augment_refusals():
    opt = make_optimizer()
    with pytest.raises(ValueError, match="spec_augment"):
        make_train_step(tiny_test_config(), opt, spec_augment=SpecAugmentConfig(),
                        mel_on_device=True)
    with pytest.raises(TypeError, match="SpecAugmentConfig"):
        make_train_step(tiny_test_config(), opt, spec_augment=True)


# ---------------------------------------------------------------------------
# LoRA
# ---------------------------------------------------------------------------

KERNELS = dict(flash_attention=True, flash_decoder_min_seq=0)


@pytest.fixture(scope="module")
def setup():
    """JAX's init and JAX-drawn adapters (b made non-zero, so the merge is
    not the identity), carried into the port."""
    jcfg = jax_tiny(flash_interpret=True, flash_block_q=16, **KERNELS)
    params = jax.tree.map(np.asarray, jax_init(jcfg, 0))
    jlora = jax.tree.map(np.asarray, jax_init_lora(params, 4, jax.random.PRNGKey(1)))
    rng = np.random.default_rng(9)
    jlora = jax.tree.map(lambda x: x if x.any() else
                         (0.02 * rng.standard_normal(x.shape)).astype(np.float32), jlora)
    cfg = tiny_test_config(**KERNELS)
    model = build_model(cfg, params_from_jax(params, cfg), device="cpu", train=True)
    model.requires_grad_(False)
    return jcfg, params, jlora, cfg, model


def _port_lora(jlora):
    return lora.lora_from_jax(jlora)


def test_init_layout_and_identity_merge(setup):
    _, _, _, cfg, model = setup
    ad = init_lora_params(model, 4, torch.Generator().manual_seed(0))
    assert set(ad) == {"encoder", "decoder"}
    assert set(ad["decoder"]) == {"self_attn", "cross_attn"} and set(ad["encoder"]) == {"attn"}
    a, b = ad["decoder"]["self_attn"]["wq"]["a"], ad["decoder"]["self_attn"]["wq"]["b"]
    assert a.shape == (2, 64, 4) and b.shape == (2, 4, 64) and not b.any()
    full = sum(p.numel() for p in model.parameters())
    assert lora_param_count(ad) < full / 20
    merged = merge_lora(model, ad)
    for (n, p), q in zip(model.named_parameters(), merged.parameters()):
        assert torch.equal(p, q), n
    assert set(init_lora_params(model, 4, include_encoder=False)) == {"decoder"}
    with pytest.raises(ValueError, match="rank"):
        init_lora_params(model, 0)


def test_merge_matches_jax(setup):
    _, params, jlora, cfg, model = setup
    want = jax.tree.map(np.asarray, jax_merge(params, jlora, alpha=16.0))
    got = state_dict_to_jax(dict(merge_lora(model, _port_lora(jlora), 16.0).named_parameters()),
                            cfg)
    for (path, w), g in zip(jax.tree_util.tree_flatten_with_path(want)[0],
                            jax.tree.leaves(got)):
        np.testing.assert_allclose(g, w, atol=1e-6, rtol=0,
                                   err_msg=jax.tree_util.keystr(path))


def _jax_loss_and_grads(jcfg, params, jlora, batch, grad_accum):
    loss_full = jax_make_loss_fn(jcfg, 1.5)

    def loss_fn(ad, b):
        return loss_full(jax_merge(jax.lax.stop_gradient(params), ad, 16.0), b)

    grad_fn = jax.value_and_grad(loss_fn)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    if grad_accum == 1:
        return grad_fn(jlora, jb)
    return jax_accumulate(lambda mb: grad_fn(jlora, mb), jlora, jb, grad_accum)


@pytest.mark.parametrize("remat", ["full", "none"])
def test_loss_and_adapter_grads_match_jax(setup, remat):
    jcfg, params, jlora, cfg, model = setup
    batch = _collated_batch(0)
    jloss, jgrads = _jax_loss_and_grads(jcfg, params, jlora, batch, ACCUM)
    cfg = tiny_test_config(**KERNELS, remat=remat)
    model = build_model(cfg, params_from_jax(params, cfg), device="cpu", train=True)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    grad_fn = lora.make_lora_grad_fn(cfg, 16.0, 1.5, grad_accum=ACCUM)
    ad = _port_lora(jlora)
    loss, grads = grad_fn(ad, model, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert float(loss) == pytest.approx(float(jloss), rel=1e-5)
    want = [np.asarray(x) for _, x in lora._leaves(jax.tree.map(np.asarray, jgrads))]
    scale = max(np.abs(w).max() for w in want)
    for (path, _), g, w in zip(lora._leaves(ad), grads, want):
        np.testing.assert_allclose(g.numpy(), w, atol=1e-4 * scale, rtol=0, err_msg=str(path))
    # the base gets no gradient and keeps its weights
    for n, p in model.named_parameters():
        assert p.grad is None and torch.equal(p, before[n]), n


def test_one_step_matches_jax(setup):
    jcfg, params, jlora, cfg, model = setup
    batch = _collated_batch(1)
    kw = dict(peak_lr=LR, warmup_steps=0, total_steps=100)
    jopt = jax_make_optimizer(**kw)
    jstep = jax_lora_step(jcfg, jopt, grad_accum=ACCUM, donate=False)
    jstate, jm = jstep(jax_init_state(jlora, jopt), params,
                       {k: jnp.asarray(v) for k, v in batch.items()})
    opt = make_optimizer(**kw)
    step = make_lora_train_step(cfg, opt, grad_accum=ACCUM)
    state, m = step(init_lora_state(_port_lora(jlora), opt), model, batch)
    assert float(m["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-5)
    assert float(m["grad_norm"]) == pytest.approx(float(jm["grad_norm"]), rel=1e-4)
    assert state.step == 1 and state.opt_state.count == 1
    want = jax.tree.map(np.asarray, jstate.params)
    for (path, got), (_, w) in zip(lora._leaves(state.model), lora._leaves(want)):
        np.testing.assert_allclose(got.numpy(), w, atol=1e-5, rtol=0, err_msg=str(path))


def test_steps_train_adapters_only(setup):
    """20 steps with SpecAugment lower the loss; the base stays bit-equal;
    the merged weights move."""
    _, _, _, cfg, model = setup
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    opt = make_optimizer(peak_lr=1e-2, warmup_steps=0, total_steps=30)
    step = make_lora_train_step(cfg, opt, spec_augment=SpecAugmentConfig(n_time_masks=0))
    state = init_lora_state(init_lora_params(model, 4, torch.Generator().manual_seed(1)), opt)
    batch = {k: v[0] for k, v in _collated_batch(3).items()}
    losses = []
    for _ in range(20):
        state, m = step(state, model, batch)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0]
    for n, p in model.named_parameters():
        assert torch.equal(p, before[n]), n
    merged = merge_lora(model, state.model)
    assert not torch.equal(merged.decoder.blocks[0].self_attn.query.weight,
                           model.decoder.blocks[0].self_attn.query.weight)


# ---------------------------------------------------------------------------
# the loop and the CLI
# ---------------------------------------------------------------------------

LOOP = dict(n_audio_layers=1, n_text_layers=1, d_model=16, n_heads=2)


def _items(tok):
    rng = np.random.default_rng(0)
    return [{"input_features": (rng.standard_normal((80, 128)) * 0.3).astype(np.float32),
             "labels": np.asarray([tok.sot, 5, 6, tok.eot], np.int32),
             "bias_spans": []} for _ in range(4)]


def _tcfg(cls, out, **over):
    kw = dict(output_dir=str(out), per_device_train_batch_size=2,
              per_device_eval_batch_size=2, gradient_accumulation_steps=1,
              num_train_epochs=1, eval_steps=2, save_steps=2, logging_steps=1,
              warmup_steps=0, generation_max_length=6, early_stopping_patience=50,
              load_best_model_at_end=False, lora_rank=2, learning_rate=1e-3,
              dataloader_num_workers=2)
    kw.update(over)
    return cls(**kw)


def test_loop_trains_adapters_like_jax(tmp_path, monkeypatch):
    """``train_and_evaluate(lora_rank=2)`` from JAX's init and (patched in)
    JAX's adapters: the same losses as the JAX loop; checkpoints hold the
    adapter tree, under 1/20 of the full size, stamped with lora_rank and
    lora_alpha, readable by JAX's loader; the returned model is the merged
    one, in the base shapes."""
    from whisper_context_biasing_tpu.train.checkpoint import load_checkpoint as jax_load

    tok = load_tokenizer()
    jcfg = jax_tiny(**LOOP)
    params = jax.tree.map(np.asarray, jax_init(jcfg, 0))
    jlora = jax.tree.map(np.asarray, jax_init_lora(params, 2, jax.random.PRNGKey(42)))
    items = _items(tok)
    from whisper_context_biasing_tpu.data.collator import SpeechSeq2SeqCollator as JaxColl

    kw = dict(pad_token_id=tok.pad_token_id, decoder_start_token_id=tok.sot,
              decoder_prev_token_id=tok.sop)
    _, jhist = jax_train_and_evaluate(jcfg, params, tok, items, items, JaxColl(**kw),
                                      _tcfg(JaxTrainingConfig, tmp_path / "jax"))
    monkeypatch.setattr(port_loop, "init_lora_params",
                        lambda model, rank, gen, include_encoder: _port_lora(jlora))
    cfg = tiny_test_config(**LOOP)
    out = tmp_path / "port"
    model, hist = train_and_evaluate(cfg, params_from_jax(params, cfg), tok, items, items,
                                     SpeechSeq2SeqCollator(**kw), _tcfg(TrainingConfig, out),
                                     device="cpu")
    assert [sorted(e) for e in hist] == [sorted(e) for e in jhist]
    for got, want in zip(hist, jhist):
        if "loss" in want:
            assert got["loss"] == pytest.approx(want["loss"], rel=1e-5)
    assert any("eval_wer" in e for e in hist)
    base = build_model(cfg, params_from_jax(params, cfg), device="cpu", train=True)
    assert [p.shape for p in model.parameters()] == [p.shape for p in base.parameters()]
    assert not torch.equal(model.decoder.blocks[0].self_attn.value.weight,
                           base.decoder.blocks[0].self_attn.value.weight)
    ckpts = list_checkpoints(str(out))
    assert ckpts
    with np.load(os.path.join(ckpts[0], "params.npz")) as z:
        n_adapter = sum(int(np.prod(z[k].shape)) for k in z.files)
    assert n_adapter < sum(p.numel() for p in base.parameters()) / 20
    with open(os.path.join(ckpts[0], "trainer_state.json")) as f:
        meta = json.load(f)
    assert meta["lora_rank"] == 2 and meta["lora_alpha"] == 16.0
    got_tree, _, _ = jax_load(ckpts[0])
    assert jax.tree.structure(got_tree) == jax.tree.structure(jlora)
    # and the JAX run's adapter checkpoint (optimizer state included) loads
    # in the port as the JAX loader reads it
    jckpt = list_checkpoints(str(tmp_path / "jax"))[0]
    want, _, _ = jax_load(jckpt)
    got, opt_state, jmeta = lora.load_lora_checkpoint(jckpt, load_opt_state=True)
    assert jmeta["lora_rank"] == 2 and opt_state.count == jmeta["step"]
    for (path, g), (_, w) in zip(lora._leaves(got), lora._leaves(want)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=str(path))


def test_loop_resumes_adapters(tmp_path):
    """A resumed LoRA run continues from the adapter checkpoint and its
    optimizer state; with load_best_model_at_end the merged best returns."""
    tok = load_tokenizer()
    cfg = tiny_test_config(**LOOP)
    items = _items(tok)
    coll = SpeechSeq2SeqCollator(pad_token_id=tok.pad_token_id, decoder_start_token_id=tok.sot,
                                 decoder_prev_token_id=tok.sop)
    tcfg = _tcfg(TrainingConfig, tmp_path, spec_augment=True, freeze_encoder=True)
    train_and_evaluate(cfg, None, tok, items, items, coll, tcfg, device="cpu")
    ad, opt_state, meta = lora.load_lora_checkpoint(list_checkpoints(str(tmp_path))[0],
                                                    load_opt_state=True)
    assert set(ad) == {"decoder"} and opt_state.count == 2 and meta["step"] == 2
    tcfg2 = _tcfg(TrainingConfig, tmp_path, spec_augment=True, freeze_encoder=True,
                  num_train_epochs=2, load_best_model_at_end=True)
    model, hist = train_and_evaluate(cfg, None, tok, items, items, coll, tcfg2, resume=True,
                                     device="cpu")
    assert max(e["step"] for e in hist) == 4
    base = build_model(cfg, None, device="cpu", train=True)
    for (n, p), q in zip(model.named_parameters(), base.parameters()):
        if n.startswith("encoder."):
            assert torch.equal(p, q), n


def test_train_cli_lora_and_spec_augment(tmp_path, monkeypatch):
    """``cli.train --lora_rank 2 --spec_augment`` trains on the CPU: the
    flags reach ``TrainingConfig``, checkpoints hold adapters, the results
    are written."""
    import wave

    from whisper_context_biasing_tpu_torch.cli import train as train_cli

    root = tmp_path / "corpus"
    rng = np.random.default_rng(0)
    for phase in ("train", "dev", "test"):
        (root / "audio" / phase).mkdir(parents=True)
        (root / "jsonl").mkdir(exist_ok=True)
        with open(root / "jsonl" / f"{phase}.jsonl", "w") as f:
            for i in range(2):
                f.write(json.dumps({"id": str(i), "file": f"a{i}.wav", "text": "take aspirin",
                                    "description": "aspirin", "bias_words": ["aspirin"]})
                        + "\n")
                with wave.open(str(root / "audio" / phase / f"a{i}.wav"), "wb") as w:
                    w.setnchannels(1)
                    w.setsampwidth(2)
                    w.setframerate(16000)
                    w.writeframes((rng.standard_normal(8000) * 3000).astype(np.int16).tobytes())
    seen = {}

    def narrow(name, **kw):
        return tiny_test_config(n_audio_ctx=1500, **LOOP, **kw)

    real = train_cli.train_and_evaluate

    def spy(model_cfg, params, tok, dtr, dev, coll, tcfg, **kw):
        seen["tcfg"] = tcfg
        return real(model_cfg, params, tok, dtr, dev, coll, tcfg, **kw)

    monkeypatch.setattr(train_cli, "get_config", narrow)
    monkeypatch.setattr(train_cli, "train_and_evaluate", spy)
    out = tmp_path / "out"
    train_cli.main(["--model", "tiny.en", "--device", "cpu", "--data_root", str(root),
                    "--data_dir", "audio", "--jsonl_data", str(root / "jsonl"),
                    "--output", str(out), "--batch", "2", "--grad_accum", "1", "--epoch", "1",
                    "--eval_steps", "1", "--save_steps", "1", "--lora_rank", "2",
                    "--spec_augment"])
    tcfg = seen["tcfg"]
    assert tcfg.lora_rank == 2 and tcfg.spec_augment and tcfg.lora_alpha == 16.0
    assert (out / "test_results.json").is_file() and (out / "bias_wer_results.json").is_file()
    with open(out / "checkpoint-1" / "trainer_state.json") as f:
        assert json.load(f)["lora_rank"] == 2
