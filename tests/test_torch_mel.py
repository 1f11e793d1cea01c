"""Port parity: the log-mel frontend and the mel kernel's plain version.

The same audio (numpy, seeded) goes through the JAX package's frontends and
the port's; on CPU tensors the port's kernel wrapper runs its plain version.
The mel kernel itself runs only on the card (chip_smoke.py holds it against
this plain version there); the tables it is given, the sparse filterbank and
the twiddles, are numpy and are checked here."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisper_context_biasing_tpu.audio.mel import log_mel_spectrogram as jax_log_mel
from whisper_context_biasing_tpu.ops.mel_kernel import log_mel_spectrogram_fused as jax_fused
from whisper_context_biasing_tpu_torch import ops
from whisper_context_biasing_tpu_torch.audio.mel import (
    log_mel_spectrogram,
    log_mel_spectrogram_np,
    mel_filter_bank,
    select_mel_frontend,
)
from whisper_context_biasing_tpu_torch.ops.mel_kernel import sparse_filterbank, twiddle_table

# f32 products in both frameworks, summed in other orders: log-mel agrees to
# well inside 1e-4 (the JAX package's own frontend tolerance vs numpy)
ATOL = 1e-4


@pytest.fixture(scope="module")
def audio():
    # the JAX package's own mel test signal (tests/test_mel.py), two seeds
    rng = np.random.default_rng(0)
    t = np.arange(480000) / 16000.0
    tones = 0.5 * np.sin(2 * np.pi * 440 * t) + 0.2 * np.sin(2 * np.pi * 1337 * t)
    return (tones + 0.05 * rng.standard_normal((2, t.size))).astype(np.float32)


def test_plain_frontend_matches_jax(audio):
    ref = np.asarray(jax_log_mel(jnp.asarray(audio), n_mels=80))
    got = log_mel_spectrogram(torch.from_numpy(audio), n_mels=80).numpy()
    assert got.shape == (2, 80, 3000)
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)


def test_kernel_plain_version_matches_jax_kernel(audio):
    ref = np.asarray(jax_fused(jnp.asarray(audio), n_mels=80, interpret=True))
    ops.reset_launch_counts()
    got = ops.log_mel_spectrogram_fused(torch.from_numpy(audio), n_mels=80).numpy()
    assert ops.launches["mel"] == 0  # a CPU tensor takes the plain version
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)


@pytest.mark.parametrize("fused", [True, False])
def test_frontends_match_numpy_reference_128_mels(audio, fused):
    ref = log_mel_spectrogram_np(audio[0], n_mels=128)
    frontend = select_mel_frontend() if fused else log_mel_spectrogram
    got = frontend(torch.from_numpy(audio[:1]), n_mels=128)[0].numpy()
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)


def test_select_mel_frontend_picks_kernel_or_plain(audio):
    """The frontend is the kernel's wrapper, which picks by the tensor's
    device: a CPU tensor runs the one plain version, bit for bit."""
    assert select_mel_frontend() is ops.log_mel_spectrogram_fused
    x = torch.from_numpy(audio)
    ops.reset_launch_counts()
    got = select_mel_frontend()(x, n_mels=80)
    assert not ops.launches
    assert torch.equal(got, log_mel_spectrogram(x, n_mels=80))


@pytest.mark.parametrize("n_mels", [80, 128])
def test_sparse_filterbank_reproduces_mel_filter_bank(n_mels):
    """The kernel's (first bin, count, offset) runs and weights rebuild the
    dense filterbank exactly, and a projection through either is the same."""
    ranges, weights = sparse_filterbank(n_mels)
    fb = mel_filter_bank(n_mels=n_mels)
    dense = np.zeros_like(fb)
    for m, (first, count, offset) in enumerate(ranges):
        dense[m, first:first + count] = weights[offset:offset + count]
    np.testing.assert_array_equal(dense, fb)
    assert ranges[:, 1].sum() == weights.size and (ranges[:, 1] > 0).all()
    power = np.random.default_rng(0).random((6, 201))
    sparse = np.stack([[p[f:f + c] @ weights[o:o + c].astype(np.float64) for f, c, o in ranges]
                       for p in power])
    np.testing.assert_allclose(sparse, power @ fb.T.astype(np.float64), rtol=1e-12, atol=0)


def test_twiddle_table_is_the_rounded_float64_table():
    """W_400^k as f32 (re, im): the float64 values rounded once, so each is
    within half an f32 ulp of exp(-2 pi i k / 400)."""
    tw = twiddle_table()
    assert tw.dtype == np.float32 and tw.shape == (400, 2)
    want = np.exp(-2j * np.pi * np.arange(400) / 400)
    for got, ref in ((tw[:, 0], want.real), (tw[:, 1], want.imag)):
        np.testing.assert_array_equal(got, ref.astype(np.float32))
        assert (np.abs(got - ref) <= np.spacing(np.abs(ref).astype(np.float32)) / 2).all()
