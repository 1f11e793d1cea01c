"""Port parity: the fused LayerNorm+matmul (K5) vs the JAX package.

The port's plain version (what its wrapper runs for CPU tensors) against the
JAX ``fused_ln_matmul`` run by its Pallas kernel in interpret mode, for every
activation in f32 and bf16, with row counts both a multiple and not a
multiple of the JAX call's 256-row padding (down to one row, and either side
of the CUDA kernel's 64- and 128-row blocks) at two widths; the choice of
the CUDA kernel's column groups; the hand-derived backward
against ``jax.grad`` of the JAX call (its ``custom_vjp``); and the fused
encoder, full-sequence decoder and WeightCE step against the JAX package's
fused config (``flash_interpret=True`` runs its kernels on the CPU)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisper_context_biasing_tpu.models import init_params as jax_init
from whisper_context_biasing_tpu.models import tiny_test_config as jax_tiny
from whisper_context_biasing_tpu.models.whisper import (
    encode_audio as jax_encode,
    forward as jax_forward,
)
from whisper_context_biasing_tpu.ops.fused_block import fused_ln_matmul as jax_fused
from whisper_context_biasing_tpu.train import init_train_state as jax_init_state
from whisper_context_biasing_tpu.train import make_optimizer as jax_make_optimizer
from whisper_context_biasing_tpu.train import make_train_step as jax_make_step
from whisper_context_biasing_tpu_torch import ops
from whisper_context_biasing_tpu_torch.ops.fused_block import bf16_smem_bytes, tiles_per_group
from whisper_context_biasing_tpu_torch.models import (
    build_model,
    encode_audio,
    forward,
    params_from_jax,
    state_dict_to_jax,
    tiny_test_config,
)
from whisper_context_biasing_tpu_torch.train import (
    init_train_state,
    make_optimizer,
    make_train_step,
)

FUSED = dict(fused_ln_qkv=True, fused_ln_mlp=True)
ACTS = [None, "gelu", "gelu_tanh"]
D, E = 64, 192


def _inputs(seed, rows, dtype, d=D):
    """x (1, rows, d), g, beta (d,) f32, w (d, E), b (E,) f32 as numpy f32,
    and the torch / JAX tensors in ``dtype`` (x and w; the LayerNorm
    parameters and the bias stay f32, as the model passes them)."""
    rng = np.random.default_rng(seed)
    a = dict(x=rng.standard_normal((1, rows, d)).astype(np.float32) * 2 + 0.5,
             g=(1.0 + 0.1 * rng.standard_normal(d)).astype(np.float32),
             beta=(0.1 * rng.standard_normal(d)).astype(np.float32),
             w=(rng.standard_normal((d, E)) * 0.2).astype(np.float32),
             b=(rng.standard_normal(E) * 0.5).astype(np.float32))
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jx = {k: jnp.asarray(v, jdt if k in ("x", "w") else jnp.float32) for k, v in a.items()}
    tx = {k: torch.from_numpy(v).to(dtype if k in ("x", "w") else torch.float32)
          for k, v in a.items()}
    return jx, tx


def _bf16_ulp(x: np.ndarray) -> float:
    """One bf16 ulp at the largest |x| (8 significant bits)."""
    return 2.0 ** (np.floor(np.log2(np.abs(x).max())) - 7)


@pytest.mark.parametrize("rows,d", [
    pytest.param(256, D, id="256"), pytest.param(300, D, id="300"), pytest.param(1, D, id="1"),
    pytest.param(63, D, id="63"), pytest.param(129, D, id="129"),
    pytest.param(1, 384, id="1-d384"), pytest.param(63, 384, id="63-d384"),
    pytest.param(129, 384, id="129-d384")])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("act", ACTS)
def test_plain_matches_jax_kernel(act, dtype, rows, d):
    jx, tx = _inputs(rows, rows, dtype, d)
    ref = np.asarray(jax_fused(jx["x"], jx["g"], jx["beta"], jx["w"], jx["b"], act=act,
                               interpret=True).astype(jnp.float32))
    ops.reset_launch_counts()
    got = ops.fused_ln_matmul(tx["x"], tx["g"], tx["beta"], tx["w"], tx["b"], act=act)
    assert not ops.launches  # CPU tensors: the plain version, no kernel
    assert got.dtype == dtype and got.shape == (1, rows, E)
    # f32: sums in other orders; bf16: the same f32 value on both sides up
    # to summation order, then one rounding, which may go either way at a
    # rounding boundary: one bf16 ulp of the largest output
    atol = 2e-5 if dtype == torch.float32 else _bf16_ulp(ref)
    np.testing.assert_allclose(got.float().numpy(), ref, atol=atol, rtol=0)


@pytest.mark.parametrize("n,d,e,want", [
    # base.en batch 8 on 132 SMs, 128-row blocks and 128-column tiles: the
    # encoder's 94 row blocks sweep all 12 QKV tiles in one wave, or the 16
    # MLP tiles in 4 groups (3 waves); the decoder's 28 row blocks split
    # their tiles 4 ways to fill one wave
    (12000, 512, 1536, 12), (12000, 512, 2048, 4),
    (3584, 512, 1536, 3), (3584, 512, 512, 1), (3584, 512, 2048, 4),
    (1, 384, 512, 1), (12000, 1280, 5120, 20)])
def test_tiles_per_group(n, d, e, want):
    assert tiles_per_group(n, d, e, 132) == want


def test_bf16_block_fits_shared_memory():
    for d in (384, 512, 768, 1024, 1280):
        assert bf16_smem_bytes(d) <= 227 * 1024, d


def test_plain_without_bias_and_unknown_activation():
    jx, tx = _inputs(1, 40, torch.float32)
    ref = np.asarray(jax_fused(jx["x"], jx["g"], jx["beta"], jx["w"], interpret=True))
    got = ops.fused_ln_matmul(tx["x"], tx["g"], tx["beta"], tx["w"])
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-5, rtol=0)
    with pytest.raises(ValueError, match="unknown activation"):
        ops.fused_ln_matmul(tx["x"], tx["g"], tx["beta"], tx["w"], act="relu")


# f32: the two backwards compute the same formula (tests/test_ops.py's
# limits for the JAX kernel's own gradients); bf16: y, ds and the gradients
# of x and w round to bf16 on both sides, and a value at a rounding boundary
# may round the other way: 1% of each gradient's largest value
GRAD_TOL = {torch.float32: dict(atol=2e-4, rtol=1e-4), torch.bfloat16: None}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("act", ACTS)
def test_grads_match_jax(act, dtype):
    jx, tx = _inputs(7, 300, dtype)
    r = np.random.default_rng(8).standard_normal((1, 300, E)).astype(np.float32)

    def jloss(x, g, beta, w, b):
        out = jax_fused(x, g, beta, w, b, act=act, interpret=True)
        return jnp.sum(out.astype(jnp.float32) * r)

    names = ("x", "g", "beta", "w", "b")
    want = jax.grad(jloss, argnums=tuple(range(5)))(*(jx[n] for n in names))
    leaves = [tx[n].clone().requires_grad_() for n in names]
    (ops.fused_ln_matmul(*leaves, act=act).float() * torch.from_numpy(r)).sum().backward()
    for name, leaf, ref in zip(names, leaves, want):
        assert leaf.grad.dtype == leaf.dtype, name
        ref = np.asarray(ref.astype(jnp.float32))
        got = leaf.grad.float().numpy()
        tol = GRAD_TOL[dtype] or dict(atol=1e-2 * np.abs(ref).max(), rtol=0)
        np.testing.assert_allclose(got, ref, err_msg=f"d{name}", **tol)


# ---------------------------------------------------------------------------
# the model with both switches on
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def weights():
    params = jax.tree.map(np.asarray, jax_init(jax_tiny(), 0))
    mel = (np.random.default_rng(3).standard_normal((2, 80, 128)) * 0.4).astype(np.float32)
    return params, mel


def _model(params, train=False, **over):
    cfg = tiny_test_config(**FUSED, **over)
    return build_model(cfg, params_from_jax(params, cfg), device="cpu", train=train)


# f32 both sides, sums in other orders through two blocks (tests/test_ops.py's
# fused-encoder limit)
ENC_ATOL = 1e-4


@pytest.mark.parametrize("flash", [False, True])
def test_fused_encoder_matches_jax(weights, flash):
    params, mel = weights
    ref = np.asarray(jax_encode(params, jax_tiny(flash_interpret=True, **FUSED),
                                jnp.asarray(mel)))
    model = _model(params, flash_attention=flash)
    ops.reset_launch_counts()
    with torch.no_grad():
        got = encode_audio(model, torch.from_numpy(mel))
    assert not ops.launches
    np.testing.assert_allclose(got.numpy(), ref, atol=ENC_ATOL, rtol=0)


# as the unfused full-sequence decoder's parity test: the vocab product's
# sums in other orders
FULL_ATOL, FULL_RTOL = 2e-4, 1e-4


@pytest.mark.parametrize("flash", [False, True])
def test_fused_full_sequence_decoder_matches_jax(weights, flash):
    params, mel = weights
    over = dict(flash_attention=flash, flash_decoder_min_seq=0)
    jcfg = jax_tiny(flash_interpret=True, flash_block_q=16, **FUSED, **over)
    ids = np.random.default_rng(5).integers(0, 50000, (2, 24)).astype(np.int32)
    ref = np.asarray(jax_forward(params, jcfg, jnp.asarray(mel), jnp.asarray(ids)))
    model = _model(params, train=True, **over)
    with torch.no_grad():
        got = forward(model, torch.from_numpy(mel), torch.from_numpy(ids))
    np.testing.assert_allclose(got.numpy(), ref, atol=FULL_ATOL, rtol=FULL_RTOL)


# tests/test_ops.py's fused-step limits: loss rel 1e-5, post-step weights
# 1e-5 (Adam's first step moves each weight by ~lr = 1e-4)
STEP_LOSS_RTOL, STEP_PARAM_ATOL = 1e-5, 1e-5


def test_fused_train_step_matches_jax(weights):
    params, _ = weights
    rng = np.random.default_rng(4)
    batch = {
        "input_features": (rng.standard_normal((2, 80, 128)) * 0.3).astype(np.float32),
        "decoder_input_ids": np.asarray([[50257, 5, 6, 7]] * 2, np.int32),
        "labels": np.asarray([[5, 6, 7, 50256]] * 2, np.int32),
        "bias_spans": np.full((2, 1, 2), 50256, np.int32),
    }
    kw = dict(peak_lr=1e-4, warmup_steps=0, total_steps=10)
    jcfg = jax_tiny(flash_interpret=True, **FUSED)
    jopt = jax_make_optimizer(**kw)
    jstate, jm = jax_make_step(jcfg, jopt, donate=False)(
        jax_init_state(params, jopt), {k: jnp.asarray(v) for k, v in batch.items()})

    model = _model(params, train=True)
    opt = make_optimizer(**kw)
    ops.reset_launch_counts()
    state, m = make_train_step(model.cfg, opt)(init_train_state(model, opt), batch)
    assert not ops.launches
    assert float(m["loss"]) == pytest.approx(float(jm["loss"]), rel=STEP_LOSS_RTOL)
    got = state_dict_to_jax(dict(model.named_parameters()), model.cfg)
    diffs = jax.tree.map(lambda a, b: float(np.max(np.abs(a - np.asarray(b)))), got,
                         jstate.params)
    worst = max(jax.tree_util.tree_flatten_with_path(diffs)[0], key=lambda kv: kv[1])
    assert worst[1] < STEP_PARAM_ATOL, worst


def test_fused_grads_reach_every_master_weight(weights):
    """The f32 masters get their gradients through the concatenated QKV
    weight and the casts: the same gradients as the unfused config up to
    f32 rounding (in f32 the two configs are one function)."""
    params, mel = weights
    ids = torch.from_numpy(np.random.default_rng(6).integers(0, 50000, (2, 12)))
    grads = []
    for fused in (True, False):
        cfg = tiny_test_config(**(FUSED if fused else {}))
        model = build_model(cfg, params_from_jax(params, cfg), device="cpu", train=True)
        forward(model, torch.from_numpy(mel), ids).logsumexp(-1).sum().backward()
        grads.append({n: p.grad for n, p in model.named_parameters()})
    for name, g in grads[1].items():
        got = grads[0][name]
        assert got is not None, name
        torch.testing.assert_close(got, g, atol=1e-4, rtol=1e-4, msg=name)
