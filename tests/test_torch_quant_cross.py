"""Port parity: int8 cross-K/V quantization and the int8 decode
cross-attention's plain version vs the JAX package (Pallas kernel in
interpret mode, and the XLA path). The CUDA kernel runs only on the card
(chip_smoke.py holds it against this plain version there)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisper_context_biasing_tpu.models.whisper import (
    _attention_quant_cross as jax_attention_quant_cross,
    quantize_cross_kv as jax_quantize,
)
from whisper_context_biasing_tpu.ops.quant_cross_attention import (
    quant_cross_attention_step_indexed as jax_step_indexed,
)
from whisper_context_biasing_tpu_torch import ops
from whisper_context_biasing_tpu_torch.models.whisper import (
    _attention_quant_cross,
    quantize_cross_kv,
)

L, B, T, D, H = 2, 3, 100, 64, 2


@pytest.fixture(scope="module")
def cross_kv():
    rng = np.random.default_rng(0)
    return [rng.standard_normal((L, B, T, D)).astype(np.float32) for _ in range(2)]


@pytest.fixture(scope="module")
def both(cross_kv):
    ref = {k: np.asarray(v) for k, v in jax_quantize(tuple(map(jnp.asarray, cross_kv))).items()}
    got = quantize_cross_kv(tuple(torch.from_numpy(x) for x in cross_kv))
    return ref, got


def test_quantize_matches_jax(both):
    ref, got = both
    for name in ("k_q", "v_q"):
        assert got[name].dtype == torch.int8 and got[name].shape == (L, B, 128, D)
        np.testing.assert_array_equal(got[name].numpy(), ref[name])  # bit-identical
    for name in ("k_s", "v_s"):
        assert got[name].shape == (L, B, 1, 128)
        np.testing.assert_allclose(got[name].numpy(), ref[name], atol=1e-7, rtol=0)
        assert not got[name][..., T:].any()  # zero scales mark the padding


@pytest.mark.parametrize("layer", range(L))
def test_step_plain_matches_jax_kernel(both, layer):
    ref_kv, kv = both
    q = np.random.default_rng(layer).standard_normal((B, 1, D)).astype(np.float32)
    ref = np.asarray(jax_step_indexed(jnp.asarray(q), *(jnp.asarray(ref_kv[n]) for n in
                                                        ("k_q", "k_s", "v_q", "v_s")),
                                      layer, H, interpret=True))
    ops.reset_launch_counts()
    got = ops.quant_cross_attention_step_indexed(
        torch.from_numpy(q), kv["k_q"], kv["k_s"], kv["v_q"], kv["v_s"], layer, H)
    assert ops.launches["quant_cross_attention"] == 0  # CPU: the plain version
    assert got.shape == (B, 1, D)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=0)


def test_multi_query_plain_matches_jax_xla_path(both):
    ref_kv, kv = both
    q = np.random.default_rng(7).standard_normal((B, 5, D)).astype(np.float32)
    ref = np.asarray(jax_attention_quant_cross(
        jnp.asarray(q), {n: jnp.asarray(a[1]) for n, a in ref_kv.items()}, H))
    got = _attention_quant_cross(torch.from_numpy(q), {n: a[1] for n, a in kv.items()}, H)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=0)
