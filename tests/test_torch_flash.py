"""Port parity: the flash-attention forward's plain version vs the JAX
Pallas kernel (interpret mode). The CUDA kernel runs only on the card
(chip_smoke.py holds it against this plain version there)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisper_context_biasing_tpu.ops.flash_attention import flash_attention as jax_flash
from whisper_context_biasing_tpu_torch import ops

# f32 both sides, sums in other orders
ATOL = 2e-5


def _qkv(b, tq, tk, d, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, t, d)).astype(np.float32) for t in (tq, tk, tk)]


@pytest.mark.parametrize("t", [100, 300])  # both pad to block_q 128 in JAX
def test_plain_matches_jax_flash(t):
    q, k, v = _qkv(2, t, t, 64, seed=t)
    ref = np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 2,
                               block_q=128, interpret=True))
    ops.reset_launch_counts()
    got = ops.flash_attention(*(torch.from_numpy(x) for x in (q, k, v)), 2).numpy()
    assert ops.launches["flash_attention"] == 0  # CPU tensors take the plain version
    assert got.shape == (2, t, 64)
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)


def test_plain_lse_and_kv_len_mask():
    q, k, v = (torch.from_numpy(x).view(2, -1, 2, 32) for x in _qkv(2, 40, 90, 64, seed=3))
    o, lse = ops.flash_attention_fwd_plain(q, k, v, kv_len=70)
    o_ref, lse_ref = ops.flash_attention_fwd_plain(q, k[:, :70], v[:, :70])
    # masking keys past kv_len equals dropping them; the f32-min scores add 0
    np.testing.assert_allclose(o.numpy(), o_ref.numpy(), atol=1e-6, rtol=0)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k[:, :70]) / np.sqrt(32)
    np.testing.assert_allclose(lse.numpy(), torch.logsumexp(scores, -1).numpy(),
                               atol=1e-5, rtol=0)
    assert lse.shape == (2, 2, 40) and lse.dtype == torch.float32


# small tiles keep the JAX interpret-mode kernels quick at T <= 64
BLOCK_Q = 16
SHAPES = {"full": (64, 64, False), "causal": (64, 64, True), "cross": (40, 64, False)}


def _heads(x):  # (B, T, 2*32) numpy -> (B, T, 2, 32) tensor
    return torch.from_numpy(x).view(x.shape[0], x.shape[1], 2, 32)


@pytest.mark.parametrize("shape", ["causal", "cross"])
def test_plain_forward_causal_and_cross_match_jax(shape):
    tq, tk, causal = SHAPES[shape]
    q, k, v = _qkv(2, tq, tk, 64, seed=11)
    ref = np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 2,
                               causal=causal, block_q=BLOCK_Q, interpret=True))
    got = ops.flash_attention(*(torch.from_numpy(x) for x in (q, k, v)), 2,
                              causal=causal).numpy()
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)


# f32 both sides, as tests/test_ops.py holds the JAX kernel's own backward
BWD_ATOL = 5e-6


@pytest.mark.parametrize("shape", list(SHAPES))
def test_plain_backward_matches_jax_vjp(shape):
    tq, tk, causal = SHAPES[shape]
    q, k, v = _qkv(2, tq, tk, 64, seed=21)
    do = np.random.default_rng(22).standard_normal((2, tq, 64)).astype(np.float32)
    _, vjp = jax.vjp(lambda a, b, c: jax_flash(a, b, c, 2, causal=causal, block_q=BLOCK_Q,
                                               interpret=True),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    ref = vjp(jnp.asarray(do))
    qt, kt, vt = (_heads(x) for x in (q, k, v))
    o, lse = ops.flash_attention_fwd_plain(qt, kt, vt, causal=causal)
    ops.reset_launch_counts()
    got = ops.flash_attention_bwd(qt, kt, vt, o, lse, _heads(do), causal=causal)
    assert ops.launches["flash_attention_bwd"] == 0  # CPU tensors take the plain version
    for g, r, x in zip(got, ref, (q, k, v)):
        assert g.shape == (2, x.shape[1], 2, 32)
        np.testing.assert_allclose(g.reshape(x.shape).numpy(), np.asarray(r),
                                   atol=BWD_ATOL, rtol=0)


@pytest.mark.parametrize("shape,kv_len", [("full", None), ("causal", None), ("cross", None),
                                          ("cross", 50)])
def test_plain_backward_matches_autograd_of_plain_forward(shape, kv_len):
    tq, tk, causal = SHAPES[shape]
    q, k, v = (_heads(x).requires_grad_() for x in _qkv(2, tq, tk, 64, seed=31))
    do = torch.from_numpy(np.random.default_rng(32).standard_normal((2, tq, 2, 32))
                          .astype(np.float32))
    o, lse = ops.flash_attention_fwd_plain(q, k, v, kv_len, causal)
    want = torch.autograd.grad(o, (q, k, v), do)
    got = ops.flash_attention_bwd_plain(q.detach(), k.detach(), v.detach(), o.detach(),
                                        lse.detach(), do, kv_len, causal)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=BWD_ATOL, rtol=0)
    if kv_len is not None:  # masked keys get exactly zero gradients
        assert not got[1][:, kv_len:].any() and not got[2][:, kv_len:].any()


def test_autograd_function_runs_the_plain_backward_on_cpu():
    q, k, v = (torch.from_numpy(x).requires_grad_() for x in _qkv(2, 64, 64, 64, seed=41))
    out = ops.flash_attention(q, k, v, 2, causal=True)
    (out * out).sum().backward()
    o, lse = ops.flash_attention_fwd_plain(*(_heads(x.detach().numpy()) for x in (q, k, v)),
                                           causal=True)
    want = ops.flash_attention_bwd_plain(*(_heads(x.detach().numpy()) for x in (q, k, v)),
                                         o, lse, 2 * o, causal=True)
    for x, w in zip((q, k, v), want):
        np.testing.assert_allclose(x.grad.numpy(), w.reshape(x.shape).numpy(), atol=1e-6,
                                   rtol=0)
    with pytest.raises(ValueError, match="Tq == Tk"):
        ops.flash_attention(q[:, :10], k, v, 2, causal=True)
