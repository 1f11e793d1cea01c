"""Port parity: int8 cross-K/V quantization and the int8 decode
cross-attention's plain version vs the JAX package (Pallas kernel in
interpret mode, and the XLA path), in f32 and bf16, at shapes that straddle
the CUDA kernel's splits of T_pad. The CUDA kernel runs only on the card
(chip_smoke.py and tests/test_torch_cuda.py hold it against this plain
version there)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisper_context_biasing_tpu.models.whisper import (
    _attention_quant_cross as jax_attention_quant_cross,
    quantize_cross_kv as jax_quantize,
)
from whisper_context_biasing_tpu.ops.quant_cross_attention import (
    quant_cross_attention_step as jax_step,
    quant_cross_attention_step_indexed as jax_step_indexed,
)
from whisper_context_biasing_tpu_torch import ops
from whisper_context_biasing_tpu_torch.ops.quant_cross_attention import pick_splits
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


def _bf16_ulp(x: np.ndarray) -> float:
    """One bf16 ulp at the largest |x| (8 significant bits)."""
    return 2.0 ** (np.floor(np.log2(np.abs(x).max())) - 7)


# (layer, dtype, shape): "module" is the (L, B, T, D, H) fixture above (T 100
# -> T_pad 128); the others are (B, T, heads, last real key): T 1,500 ->
# T_pad 1,536 at 6, 8 and 20 heads of 64, and one whose keys past 1,024 are
# all masked, so that the last 512-row split of the CUDA kernel is padding
STEP_CASES = [
    *(pytest.param(layer, "float32", "module", id=str(layer)) for layer in range(L)),
    *(pytest.param(layer, "bfloat16", "module", id=f"bf16-{layer}") for layer in range(L)),
    pytest.param(1, "float32", (2, 1500, 8, 1500), id="f32-1500x8"),
    pytest.param(1, "bfloat16", (2, 1500, 8, 1500), id="bf16-1500x8"),
    pytest.param(0, "bfloat16", (2, 1500, 6, 1500), id="bf16-1500x6"),
    pytest.param(1, "bfloat16", (2, 1500, 20, 1500), id="bf16-1500x20"),
    pytest.param(0, "float32", (2, 1500, 8, 1024), id="f32-last-split-padding"),
    pytest.param(1, "bfloat16", (2, 1500, 8, 1024), id="bf16-last-split-padding"),
]


@pytest.mark.parametrize("layer,dtype,shape", STEP_CASES)
def test_step_plain_matches_jax_kernel(both, layer, dtype, shape):
    if shape == "module":
        (ref_kv, kv), b, d, h = both, B, D, H
    else:
        b, t, h, last = shape
        d = 64 * h
        rng = np.random.default_rng(t + h)
        cross = [rng.standard_normal((2, b, t, d)).astype(np.float32) for _ in range(2)]
        ref_kv = {k: np.array(v) for k, v in jax_quantize(tuple(map(jnp.asarray, cross))).items()}
        ref_kv["k_s"][..., last:] = 0.0  # a zero scale masks the key
        kv = {k: torch.from_numpy(v) for k, v in ref_kv.items()}
    q = np.random.default_rng(layer).standard_normal((b, 1, d)).astype(np.float32)
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if dtype == "bfloat16" else (jnp.float32,
                                                                         torch.float32)
    ref = np.asarray(jax_step_indexed(jnp.asarray(q, jdt), *(jnp.asarray(ref_kv[n]) for n in
                                                             ("k_q", "k_s", "v_q", "v_s")),
                                      layer, h, interpret=True).astype(jnp.float32))
    ops.reset_launch_counts()
    got = ops.quant_cross_attention_step_indexed(
        torch.from_numpy(q).to(tdt), kv["k_q"], kv["k_s"], kv["v_q"], kv["v_s"], layer, h)
    assert ops.launches["quant_cross_attention"] == 0  # CPU: the plain version
    assert got.shape == (b, 1, d) and got.dtype == tdt
    # f32: sums in other orders; bf16: the weights round to bf16 before the
    # product on both sides (a value at a rounding boundary may go either way)
    # and the output once more: one bf16 ulp of the largest output
    atol = 1e-5 if dtype == "float32" else _bf16_ulp(ref)
    np.testing.assert_allclose(got.float().numpy(), ref, atol=atol, rtol=0)


@pytest.mark.parametrize("t_pad,rows_heads,want", [
    (1536, 64, 3),     # serving: 8 rows x 8 heads -> 192 blocks of 512 keys
    (1536, 8, 8),      # one row: as many blocks as a cluster holds
    (1536, 64 * 20, 3),  # a large batch still needs slices of at most 512 keys
    (128, 4, 2), (192, 4, 3), (4096, 1, 8)])
def test_pick_splits(t_pad, rows_heads, want):
    assert pick_splits(t_pad, rows_heads) == want
    assert t_pad % (want * 64) == 0 and t_pad // want <= 512


def test_pick_splits_rejects_what_no_cluster_covers():
    with pytest.raises(ValueError, match="T_pad = 4160"):
        pick_splits(4160, 8)   # 65 x 64 rows: more than 8 blocks of 512
    with pytest.raises(ValueError, match="T_pad = 100"):
        pick_splits(100, 8)    # not a multiple of 64


def test_multi_query_plain_matches_jax_xla_path(both):
    ref_kv, kv = both
    q = np.random.default_rng(7).standard_normal((B, 5, D)).astype(np.float32)
    ref = np.asarray(jax_attention_quant_cross(
        jnp.asarray(q), {n: jnp.asarray(a[1]) for n, a in ref_kv.items()}, H))
    got = _attention_quant_cross(torch.from_numpy(q), {n: a[1] for n, a in kv.items()}, H)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_one_layer_step_matches_jax_kernel(both, dtype):
    """``quant_cross_attention_step`` (K3 on one layer's K/V) on a CPU
    tensor: its plain version against the JAX function's Pallas kernel in
    interpret mode."""
    ref_kv, kv = both
    q = np.random.default_rng(3).standard_normal((B, 1, D)).astype(np.float32)
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if dtype == "bfloat16" else (jnp.float32,
                                                                         torch.float32)
    ref = np.asarray(jax_step(jnp.asarray(q, jdt), *(jnp.asarray(ref_kv[n][1]) for n in
                                                     ("k_q", "k_s", "v_q", "v_s")),
                              H, interpret=True).astype(jnp.float32))
    ops.reset_launch_counts()
    got = ops.quant_cross_attention_step(torch.from_numpy(q).to(tdt),
                                         *(kv[n][1] for n in ("k_q", "k_s", "v_q", "v_s")), H)
    assert not ops.launches  # CPU: the plain version
    assert got.shape == (B, 1, D) and got.dtype == tdt
    atol = 1e-5 if dtype == "float32" else _bf16_ulp(ref)
    np.testing.assert_allclose(got.float().numpy(), ref, atol=atol, rtol=0)
