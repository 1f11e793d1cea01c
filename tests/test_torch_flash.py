"""Port parity: the flash-attention plain versions, forward and backward, in
f32 and bf16, vs the JAX Pallas kernels (interpret mode), and the layout
check the wrappers make before a launch. The CUDA kernels run only on the
card (chip_smoke.py and tests/test_torch_cuda.py hold them against these
plain versions there)."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisper_context_biasing_tpu.ops.flash_attention import flash_attention as jax_flash
from whisper_context_biasing_tpu_torch import ops
from whisper_context_biasing_tpu_torch.ops.flash_attention import _check_kernel_inputs

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


# ---------------------------------------------------------------------------
# bf16: the dtype of the tensor-core kernels. Both sides round P (and dS) to
# bf16 before the products and the outputs once at the end; the f32 sums
# between run in other orders, so a value at a rounding boundary may land on
# either neighbour: the limit is one bf16 ulp of each output's largest value.
# ---------------------------------------------------------------------------

def _bf16_ulp(x: float) -> float:
    """The spacing of bf16 values (8 significand bits) at magnitude x."""
    return 2.0 ** (math.floor(math.log2(x)) - 7)


def _bf16_heads(x):  # (B, T, 2*32) f32 numpy -> (B, T, 2, 32) bf16 tensor
    return torch.from_numpy(x).to(torch.bfloat16).view(x.shape[0], x.shape[1], 2, 32)


def _assert_within_one_ulp(got: torch.Tensor, ref: jax.Array, what: str):
    assert got.dtype == torch.bfloat16 and ref.dtype == jnp.bfloat16, what
    ref = np.asarray(ref.astype(jnp.float32))
    got = got.float().reshape(ref.shape).numpy()
    np.testing.assert_allclose(got, ref, atol=_bf16_ulp(np.abs(ref).max()), rtol=0,
                               err_msg=what)


@pytest.mark.parametrize("shape", list(SHAPES))
def test_plain_forward_bf16_matches_jax(shape):
    tq, tk, causal = SHAPES[shape]
    q, k, v = _qkv(2, tq, tk, 64, seed=51)
    ref = jax_flash(*(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)), 2, causal=causal,
                    block_q=BLOCK_Q, interpret=True)
    o, lse = ops.flash_attention_fwd(*(_bf16_heads(x) for x in (q, k, v)), causal=causal)
    assert lse.dtype == torch.float32
    _assert_within_one_ulp(o, ref, f"o {shape}")


@pytest.mark.parametrize("shape", list(SHAPES))
def test_plain_backward_bf16_matches_jax_vjp(shape):
    tq, tk, causal = SHAPES[shape]
    q, k, v = _qkv(2, tq, tk, 64, seed=61)
    do = np.random.default_rng(62).standard_normal((2, tq, 64)).astype(np.float32)
    _, vjp = jax.vjp(lambda a, b, c: jax_flash(a, b, c, 2, causal=causal, block_q=BLOCK_Q,
                                               interpret=True),
                     *(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)))
    ref = vjp(jnp.asarray(do, jnp.bfloat16))
    qt, kt, vt = (_bf16_heads(x) for x in (q, k, v))
    o, lse = ops.flash_attention_fwd_plain(qt, kt, vt, causal=causal)
    got = ops.flash_attention_bwd(qt, kt, vt, o, lse, _bf16_heads(do), causal=causal)
    for name, g, r in zip(("dq", "dk", "dv"), got, ref):
        _assert_within_one_ulp(g, r, f"{name} {shape}")


# ---------------------------------------------------------------------------
# what the bf16 kernels' 16-byte copies need of a tensor, checked by the
# wrappers before a launch (here on CPU tensors, whose storage is 64-byte
# aligned as the CUDA allocator's is)
# ---------------------------------------------------------------------------

def _layout(name: str, dtype: torch.dtype) -> torch.Tensor:
    """A (2, 10, 2, 64) tensor of ``dtype`` laid out as ``name`` says."""
    if name == "contiguous":
        return torch.zeros((2, 10, 2, 64), dtype=dtype)
    if name == "batch strided":  # every other batch row of a larger tensor
        return torch.zeros((4, 10, 2, 64), dtype=dtype)[::2]
    if name == "fused qkv slice":  # k of a (B, T, 3 * 128) projection output
        return torch.zeros((2, 10, 384), dtype=dtype)[..., 128:256].view(2, 10, 2, 64)
    if name == "one-row axes":  # axes of size 1 may carry any stride
        return torch.zeros((1, 1, 2, 64), dtype=dtype).as_strided((1, 1, 2, 64), (3, 5, 64, 1))
    if name == "offset by one element":
        return torch.zeros(2 * 10 * 2 * 64 + 1, dtype=dtype)[1:].view(2, 10, 2, 64)
    if name == "odd row stride":  # rows of 129 elements, 128 of them read
        return torch.zeros((2, 10, 129), dtype=dtype)[..., :128].view(2, 10, 2, 64)
    if name == "head stride 68":  # heads 4 elements (8 bytes) past a 16-byte boundary
        return torch.zeros((2, 10, 2, 68), dtype=dtype)[..., :64]
    raise KeyError(name)


@pytest.mark.parametrize("layout,dtype,ok", [
    ("contiguous", torch.bfloat16, True),
    ("batch strided", torch.bfloat16, True),
    ("fused qkv slice", torch.bfloat16, True),
    ("one-row axes", torch.bfloat16, True),
    ("offset by one element", torch.bfloat16, False),
    ("odd row stride", torch.bfloat16, False),
    ("head stride 68", torch.bfloat16, False),
    # the f32 kernels load element by element: any strides, any offset
    ("offset by one element", torch.float32, True),
    ("odd row stride", torch.float32, True),
])
def test_kernel_input_alignment_check(layout, dtype, ok):
    good = torch.zeros((2, 10, 2, 64), dtype=dtype)
    x = _layout(layout, dtype)
    if x.shape != good.shape:
        good = torch.zeros(x.shape, dtype=dtype)
    tensors = dict(q=good, k=x, v=good)  # k carries the layout under test
    if ok:
        _check_kernel_inputs("flash attention", tensors, x.shape[1], x.shape[1])
    else:
        with pytest.raises(ValueError, match="tensor k must start on a 16-byte boundary"):
            _check_kernel_inputs("flash attention", tensors, x.shape[1], x.shape[1])


@pytest.mark.parametrize("fused", [False, True])
def test_model_attention_inputs_pass_the_alignment_check(monkeypatch, fused):
    """Every (q, k, v) the bf16 model hands to flash attention (the
    projections' outputs, or views of the fused QKV projection under
    ``fused_ln_qkv``; encoder, causal and cross uses) is laid out as the
    kernels' 16-byte copies need."""
    from whisper_context_biasing_tpu_torch.models import build_model, tiny_test_config, whisper

    seen = []

    def spy(q, k, v, n_heads, causal=False):
        seen.append((q, k, v))
        return ops.flash_attention(q, k, v, n_heads, causal=causal)

    monkeypatch.setattr(whisper, "flash_attention", spy)
    cfg = tiny_test_config(n_heads=1, dtype="bfloat16", flash_attention=True,
                           flash_decoder_min_seq=0, fused_ln_qkv=fused, remat="none")
    model = build_model(cfg, seed=0, device="cpu")
    rng = np.random.default_rng(71)
    mel = torch.from_numpy(rng.standard_normal((2, 80, 128)).astype(np.float32))
    tokens = torch.from_numpy(rng.integers(100, 5000, (2, 12)))
    whisper.forward(model, mel, tokens)
    assert len(seen) == cfg.n_audio_layers + 2 * cfg.n_text_layers
    for q, k, v in seen:
        assert q.dtype == torch.bfloat16
        if fused and k.shape[1] == q.shape[1]:  # self-attention: slices of one projection
            assert not k.is_contiguous()
        tensors = {n: x.view(*x.shape[:2], cfg.n_heads, 64) for n, x in
                   (("q", q), ("k", k), ("v", v))}
        _check_kernel_inputs("flash attention", tensors, k.shape[1], k.shape[1])
