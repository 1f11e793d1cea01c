"""Whisper log-mel frontend.

The numpy half (filterbank, window, DFT basis, ``pad_or_trim`` and the
float64 reference) is a copy of the JAX package's ``audio/mel.py``. The
batched frontend is torch: the mel kernel's plain version
(``ops/mel_kernel.py``: a framed matmul against the real DFT basis, then the
mel projection, both in true float32; the caller keeps TF32 off on a card),
then the log tail.

Public Whisper parameters: 16 kHz audio padded/trimmed to 30 s (480000
samples), n_fft=400, hop=160, periodic Hann window, centered frames (reflect
pad), 80 mel filters (128 for large-v3), Slaney scale + Slaney norm, fmax=8k,
``log10(clamp(.,1e-10))`` -> per-utterance dynamic-range clamp at max-8 ->
``(x+4)/4``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

SAMPLE_RATE = 16000
N_FFT = 400
HOP_LENGTH = 160
CHUNK_LENGTH = 30
N_SAMPLES = CHUNK_LENGTH * SAMPLE_RATE  # 480000
N_FRAMES = N_SAMPLES // HOP_LENGTH  # 3000


def _hertz_to_mel_slaney(freq):
    """Slaney mel scale (public formula): linear below 1 kHz, log above."""
    freq = np.asarray(freq, dtype=np.float64)
    min_log_hz = 1000.0
    min_log_mel = 15.0
    logstep = 27.0 / np.log(6.4)
    mels = 3.0 * freq / 200.0
    safe = np.maximum(freq, 1e-12)  # avoid log(0) in the unselected branch
    return np.where(freq >= min_log_hz, min_log_mel + np.log(safe / min_log_hz) * logstep, mels)


def _mel_to_hertz_slaney(mels):
    mels = np.asarray(mels, dtype=np.float64)
    min_log_mel = 15.0
    logstep = np.log(6.4) / 27.0
    freq = 200.0 * mels / 3.0
    return np.where(mels >= min_log_mel, 1000.0 * np.exp(logstep * (mels - min_log_mel)), freq)


@functools.lru_cache(maxsize=4)
def mel_filter_bank(
    n_freqs: int = N_FFT // 2 + 1,
    n_mels: int = 80,
    f_min: float = 0.0,
    f_max: float = 8000.0,
    sample_rate: int = SAMPLE_RATE,
) -> np.ndarray:
    """Slaney-normalized triangular mel filterbank, shape (n_mels, n_freqs).
    Matches HF ``mel_filter_bank(..., norm="slaney", mel_scale="slaney")``."""
    fft_freqs = np.linspace(0.0, sample_rate / 2, n_freqs)
    mel_pts = np.linspace(_hertz_to_mel_slaney(f_min), _hertz_to_mel_slaney(f_max), n_mels + 2)
    hz_pts = _mel_to_hertz_slaney(mel_pts)

    fdiff = np.diff(hz_pts)
    slopes = hz_pts[None, :] - fft_freqs[:, None]  # (n_freqs, n_mels+2)
    down = -slopes[:, :-2] / fdiff[:-1]
    up = slopes[:, 2:] / fdiff[1:]
    fb = np.maximum(0.0, np.minimum(down, up)).T  # (n_mels, n_freqs)

    enorm = 2.0 / (hz_pts[2 : n_mels + 2] - hz_pts[:n_mels])
    fb *= enorm[:, None]
    return fb.astype(np.float32)


@functools.lru_cache(maxsize=1)
def hann_window_periodic(n: int = N_FFT) -> np.ndarray:
    i = np.arange(n, dtype=np.float64)
    return (0.5 * (1.0 - np.cos(2.0 * np.pi * i / n))).astype(np.float32)


@functools.lru_cache(maxsize=2)
def dft_basis(n_fft: int = N_FFT) -> np.ndarray:
    """Real DFT basis: (n_fft, 2*(n_fft//2+1)) with [cos | -sin] columns so that
    frames @ basis = [Re(rfft) | Im(rfft)]."""
    n_bins = n_fft // 2 + 1
    k = np.arange(n_bins, dtype=np.float64)
    n = np.arange(n_fft, dtype=np.float64)
    ang = 2.0 * np.pi * np.outer(n, k) / n_fft
    return np.concatenate([np.cos(ang), -np.sin(ang)], axis=1).astype(np.float32)


def pad_or_trim(audio: np.ndarray, length: int = N_SAMPLES) -> np.ndarray:
    """Host-side pad/trim to the fixed 30 s window."""
    audio = np.asarray(audio, dtype=np.float32)
    if audio.shape[-1] >= length:
        return audio[..., :length]
    pad = [(0, 0)] * (audio.ndim - 1) + [(0, length - audio.shape[-1])]
    return np.pad(audio, pad)


def log_mel_spectrogram_np(audio: np.ndarray, n_mels: int = 80) -> np.ndarray:
    """Reference implementation, one utterance: (480000,) -> (n_mels, 3000)."""
    audio = pad_or_trim(audio).astype(np.float64)
    padded = np.pad(audio, N_FFT // 2, mode="reflect")
    idx = np.arange(N_FRAMES + 1)[:, None] * HOP_LENGTH + np.arange(N_FFT)[None, :]
    frames = padded[idx] * hann_window_periodic().astype(np.float64)
    spec = np.fft.rfft(frames, axis=-1)
    power = np.abs(spec[:-1]) ** 2  # drop the trailing frame -> 3000
    mel = power @ mel_filter_bank(n_mels=n_mels).astype(np.float64).T
    log_spec = np.log10(np.maximum(mel, 1e-10))
    log_spec = np.maximum(log_spec, log_spec.max() - 8.0)
    return (((log_spec + 4.0) / 4.0).T).astype(np.float32)  # (n_mels, frames)


# ---------------------------------------------------------------------------
# torch frontend (batched)
# ---------------------------------------------------------------------------

def log_mel_tail(mel: torch.Tensor) -> torch.Tensor:
    """Mel energies (B, T, n_mels) -> log-mel features (B, n_mels, T):
    log10 with a 1e-10 floor, per-clip clamp at max-8, then (x+4)/4."""
    log_spec = torch.log10(torch.clamp(mel, min=1e-10))
    peak = log_spec.amax(dim=(1, 2), keepdim=True)
    log_spec = torch.maximum(log_spec, peak - 8.0)
    return ((log_spec + 4.0) / 4.0).transpose(1, 2)


def log_mel_spectrogram(audio: torch.Tensor, n_mels: int = 80) -> torch.Tensor:
    """Batched log-mel, plain torch on any device: (B, n_samples) f32 ->
    (B, n_mels, n_samples/160). The counterpart of the JAX package's
    ``audio.mel.log_mel_spectrogram``: the mel kernel's plain version
    (``ops.mel_kernel.mel_energies_plain``), then the log tail. n_samples is
    480000 for the 30 s window; shorter hop-aligned windows work too."""
    from ..ops.mel_kernel import mel_energies_plain  # ops imports this module

    if audio.ndim == 1:
        audio = audio[None]
    return log_mel_tail(mel_energies_plain(audio.to(torch.float32), n_mels))


def select_mel_frontend():
    """The log-mel frontend, chosen by the tensor's device: the mel kernel's
    wrapper (ops/mel_kernel.py), which launches the kernel on a CUDA tensor
    and runs its plain version on a CPU tensor. Returns a callable
    ``(audio, n_mels=80) -> (B, n_mels, T)``."""
    from ..ops.mel_kernel import log_mel_spectrogram_fused

    return log_mel_spectrogram_fused
