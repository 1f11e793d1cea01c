"""Port parity: the remat policies "dots" and "wide" (ROADMAP A.5).

``remat="dots"`` (``dots_with_no_batch_dims_saveable``, as selective
checkpointing) and ``remat="wide"`` (everything saved but the 4*d-wide MLP
tensors) against the JAX package's ``make_train_step`` under the same
policy: the same loss, gradients and update. Against the port's own
``remat="none"`` they give the same gradients to 1e-6. What each policy
recomputes is counted through the kernels' wrappers (their plain versions on
CPU tensors): the calls a step makes of the flash forward, the flash
backward and the fused LayerNorm+matmul, per layer the counts that
``chip_smoke.py`` phase 15 (c) holds at base.en."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisper_context_biasing_tpu.models import init_params as jax_init
from whisper_context_biasing_tpu.models import tiny_test_config as jax_tiny
from whisper_context_biasing_tpu.train import init_train_state as jax_init_state
from whisper_context_biasing_tpu.train import make_optimizer as jax_make_optimizer
from whisper_context_biasing_tpu.train import make_train_step as jax_make_step
from whisper_context_biasing_tpu_torch.data.collator import SpeechSeq2SeqCollator
from whisper_context_biasing_tpu_torch.models import (
    build_model,
    params_from_jax,
    state_dict_to_jax,
    tiny_test_config,
)
from whisper_context_biasing_tpu_torch.train import init_train_state, make_optimizer
from whisper_context_biasing_tpu_torch.train.step import (
    accumulate_microbatch_grads,
    make_loss_fn,
    make_train_step,
)

LR = 1e-3
ACCUM = 2
PAD = 50256
# as tests/test_torch_train.py: f32 both sides, other summation orders
STEP_LOSS_RTOL = 1e-5
GRAD_ATOL = 1e-5
PARAM_ATOL = 0.1 * LR
# the kernels' modules (the package re-exports functions of the same names)
flash_mod = importlib.import_module("whisper_context_biasing_tpu_torch.ops.flash_attention")
fused_mod = importlib.import_module("whisper_context_biasing_tpu_torch.ops.fused_block")
# the fused and flash configuration of the counts (2 + 2 layers)
KERNELS = dict(flash_attention=True, flash_decoder_min_seq=0, fused_ln_qkv=True,
               fused_ln_mlp=True)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(seed=0, rows=4, label_len=24):
    """Prompted label rows with planted bias spans through the port's
    collator, split into ACCUM microbatches."""
    rng = np.random.default_rng(seed)
    items = []
    for i in range(rows):
        ctx = list(rng.integers(100, 5000, 3 + i))
        text = list(rng.integers(100, 5000, label_len - len(ctx) - 3 - i))
        items.append({
            "input_features": (rng.standard_normal((80, 128)) * 0.5).astype(np.float32),
            "labels": [50360, *ctx, 50257, *text, 50256],
            "bias_spans": [text[2:4], list(rng.integers(100, 5000, 2))],
        })
    coll = SpeechSeq2SeqCollator(pad_token_id=PAD, decoder_start_token_id=50257,
                                 decoder_prev_token_id=50360, max_target_length=label_len)
    batch = coll(items)
    return {k: v.reshape(ACCUM, rows // ACCUM, *v.shape[1:]) for k, v in batch.items()}


@pytest.fixture(scope="module")
def jax_params():
    return jax.tree.map(np.asarray, jax_init(jax_tiny(), 0))


def _leaves(tree):
    return dict(jax.tree_util.tree_flatten_with_path(tree)[0])


@pytest.mark.parametrize("remat", ["dots", "wide"])
def test_remat_step_matches_jax(jax_params, remat):
    """One optimizer step under the policy in both packages, from the same
    weights and batch: the loss, the grad norm and every updated weight."""
    batch = _batch(0)
    kw = dict(peak_lr=LR, warmup_steps=0, total_steps=100)
    jcfg = jax_tiny(remat=remat)
    jopt = jax_make_optimizer(**kw)
    jstep = jax_make_step(jcfg, jopt, bias_weight=1.5, grad_accum=ACCUM, donate=False)
    jstate, jm = jstep(jax_init_state(jax_params, jopt),
                       {k: jnp.asarray(v) for k, v in batch.items()})

    cfg = tiny_test_config(remat=remat)
    model = build_model(cfg, params_from_jax(jax_params, cfg), device="cpu", train=True)
    opt = make_optimizer(**kw)
    state, m = make_train_step(cfg, opt, bias_weight=1.5, grad_accum=ACCUM)(
        init_train_state(model, opt), batch)
    assert float(m["loss"]) == pytest.approx(float(jm["loss"]), rel=STEP_LOSS_RTOL)
    assert float(m["grad_norm"]) == pytest.approx(float(jm["grad_norm"]), rel=STEP_LOSS_RTOL)
    want = _leaves(jstate.params)
    got = _leaves(state_dict_to_jax(dict(model.named_parameters()), cfg))
    assert want.keys() == got.keys()
    for path, g in got.items():
        np.testing.assert_allclose(g, np.asarray(want[path]), atol=PARAM_ATOL, rtol=0,
                                   err_msg=jax.tree_util.keystr(path))


def _grads(remat, **over):
    batch = {k: torch.from_numpy(v) for k, v in _batch(3).items()}
    cfg = tiny_test_config(remat=remat, **over)
    model = build_model(cfg, seed=0, device="cpu", train=True)
    return accumulate_microbatch_grads(make_loss_fn(cfg, 1.5), model, batch, ACCUM)


@pytest.mark.parametrize("kernels", [False, True], ids=["plain", "flash_fused"])
@pytest.mark.parametrize("remat", ["dots", "wide"])
def test_remat_matches_none(remat, kernels):
    """The policy changes what is recomputed, not the gradients (as
    tests/test_torch_train.py's none-against-full)."""
    over = KERNELS if kernels else {}
    loss, grads = _grads(remat, **over)
    ref_loss, ref = _grads("none", **over)
    assert float(loss) == pytest.approx(float(ref_loss), rel=1e-6)
    for a, b in zip(grads, ref):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=0)


def _layer_counts(cfg):
    """Per microbatch: (flash forward calls, flash backward calls, fused
    calls) of a step without recompute, and the fused calls at the MLP
    sites (one an encoder layer, one a decoder layer)."""
    enc, dec = cfg.n_audio_layers, cfg.n_text_layers
    flash = enc + 2 * dec          # encoder self; decoder causal self + cross
    fused = 2 * enc + 3 * dec      # QKV + MLP; decoder QKV + cross q + MLP
    return flash, flash, fused, enc + dec


# calls a step under each policy, per microbatch, from _layer_counts' terms:
# "full" and "dots" rerun every block's forward kernels in the backward
# (a ctypes launch is no aten mm, so "dots" cannot keep its output, as a
# pallas_call is no dot in JAX); "wide" reruns only the MLP sites' fused
# kernel. At base.en (6 + 6 layers, 2 microbatches) these are phase 15 (c)'s
# none 36 / 36 / 60, full and dots 72 / 36 / 120, wide 36 / 36 / 84.
POLICY = {
    "none": lambda f, b, u, mlp: (f, b, u),
    "full": lambda f, b, u, mlp: (2 * f, b, 2 * u),
    "dots": lambda f, b, u, mlp: (2 * f, b, 2 * u),
    "wide": lambda f, b, u, mlp: (f, b, u + mlp),
}


@pytest.mark.parametrize("remat", list(POLICY))
def test_recompute_counts(remat, monkeypatch):
    counts = {"fwd": 0, "bwd": 0, "fused": 0}

    def counted(key, fn):
        def wrapper(*a, **k):
            counts[key] += 1
            return fn(*a, **k)
        return wrapper

    monkeypatch.setattr(flash_mod, "flash_attention_fwd",
                        counted("fwd", flash_mod.flash_attention_fwd))
    monkeypatch.setattr(flash_mod, "flash_attention_bwd",
                        counted("bwd", flash_mod.flash_attention_bwd))
    monkeypatch.setattr(fused_mod, "fused_ln_matmul_fwd",
                        counted("fused", fused_mod.fused_ln_matmul_fwd))
    cfg = tiny_test_config(remat=remat, **KERNELS)
    model = build_model(cfg, seed=0, device="cpu", train=True)
    opt = make_optimizer(peak_lr=LR, warmup_steps=0, total_steps=10)
    make_train_step(cfg, opt, grad_accum=ACCUM)(init_train_state(model, opt), _batch(1))
    want = tuple(ACCUM * n for n in POLICY[remat](*_layer_counts(cfg)))
    assert (counts["fwd"], counts["bwd"], counts["fused"]) == want
    base = tiny_test_config(n_audio_layers=6, n_text_layers=6)
    at_base = tuple(2 * n for n in POLICY[remat](*_layer_counts(base)))
    assert at_base == {"none": (36, 36, 60), "full": (72, 36, 120), "dots": (72, 36, 120),
                       "wide": (36, 36, 84)}[remat]


def test_unknown_policy_raises():
    with pytest.raises(ValueError, match="unknown remat policy"):
        tiny_test_config(remat="some")
