"""Port parity: the flash-attention forward's plain version vs the JAX
Pallas kernel (interpret mode). The CUDA kernel runs only on the card
(chip_smoke.py holds it against this plain version there)."""

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
