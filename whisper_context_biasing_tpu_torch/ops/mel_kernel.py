"""Log-mel frontend: the CUDA mel kernel and its plain torch version.

The counterpart of the JAX package's ``ops/mel_kernel.py``
(``log_mel_spectrogram_fused``). The kernel (``csrc/mel.cu``) frames the
reflect-padded audio itself, applies the Hann window, runs a 400-point real
FFT (a 200-point mixed-radix complex FFT and a post-twiddle), forms the
power spectrum and walks each mel filter's nonzero bins, all in true f32.
The plain version is the function's definition: the dense Hann-folded DFT
basis ``[cos | -sin]`` (zero-padded from 402 to 2x256 columns) and the dense
filterbank. The two are different algorithms, held together by a tolerance
(1e-4 on log-mel). The log/clamp/affine tail runs in torch on both routes,
as in JAX.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..audio.mel import (
    HOP_LENGTH,
    N_FFT,
    dft_basis,
    hann_window_periodic,
    log_mel_tail,
    mel_filter_bank,
)
from . import _build

N_BINS = N_FFT // 2 + 1    # 201
BINS_PAD = 256
_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    # audio, batch, n_samples, twiddles, window, ranges, weights, n_mels, nnz, out, stream
    "wcb_mel": [_P, _I, _I, _P, _P, _P, _P, _I, _I, _P, _P],
    "wcb_mel_info": [_I, _I, _P],  # n_mels, nnz, int out[5]
}


def frame_audio(audio: torch.Tensor) -> torch.Tensor:
    """(B, n_samples) -> centered (B, n_samples/160, 400) frames: reflect pad
    of 200 on each side, hop 160; the trailing (T+1th) frame is never built."""
    n_frames = audio.shape[1] // HOP_LENGTH
    padded = torch.nn.functional.pad(
        audio[:, None], (N_FFT // 2, N_FFT // 2), mode="reflect")[:, 0]
    return padded.unfold(1, N_FFT, HOP_LENGTH)[:, :n_frames]


def interleaved_matmul(frames: torch.Tensor, basis: torch.Tensor) -> torch.Tensor:
    """frames (..., 400) @ basis (400, K) as two interleaved partial sums,
    over the even and over the odd samples, added at the end. A single
    400-term f32 running sum of a loud frame rounds enough to move quiet mel
    bins by ~1e-4 in log-mel; the split halves that. (The kernel does not
    sum this way: its FFT rounds less, and a tolerance holds the two
    together.)"""
    return frames[..., 0::2] @ basis[0::2] + frames[..., 1::2] @ basis[1::2]


@functools.lru_cache(maxsize=2)
def _windowed_basis() -> np.ndarray:
    """(400, 2*BINS_PAD): [cos | 0-pad | -sin | 0-pad], with the Hann window
    folded into the basis rows (one product does window + DFT)."""
    b = dft_basis() * hann_window_periodic()[:, None]  # (400, 402)
    out = np.zeros((N_FFT, 2 * BINS_PAD), np.float32)
    out[:, :N_BINS] = b[:, :N_BINS]
    out[:, BINS_PAD : BINS_PAD + N_BINS] = b[:, N_BINS:]
    return out


@functools.lru_cache(maxsize=4)
def _padded_fb(n_mels: int) -> np.ndarray:
    """(BINS_PAD, n_mels): mel filterbank, zero rows beyond bin 201."""
    fb = mel_filter_bank(n_mels=n_mels)  # (n_mels, 201)
    out = np.zeros((BINS_PAD, n_mels), np.float32)
    out[:N_BINS] = fb.T
    return out


@functools.lru_cache(maxsize=8)
def _constants(device: torch.device, n_mels: int) -> tuple[torch.Tensor, torch.Tensor]:
    return (torch.from_numpy(_windowed_basis()).to(device),
            torch.from_numpy(_padded_fb(n_mels)).to(device))


@functools.lru_cache(maxsize=1)
def twiddle_table() -> np.ndarray:
    """(400, 2) f32: W_400^k = exp(-2 pi i k / 400) as (re, im), computed in
    float64 and rounded once. Every twiddle of the kernel's FFT is one of
    these."""
    w = np.exp(-2j * np.pi * np.arange(N_FFT, dtype=np.float64) / N_FFT)
    return np.stack([w.real, w.imag], axis=1).astype(np.float32)


@functools.lru_cache(maxsize=4)
def sparse_filterbank(n_mels: int) -> tuple[np.ndarray, np.ndarray]:
    """The mel filterbank as the kernel walks it: ``ranges`` (n_mels, 3)
    int32 of (first bin, count, offset into weights) and ``weights`` f32,
    each filter's run of bins from its first to its last nonzero, with the
    values ``mel_filter_bank`` holds there."""
    fb = mel_filter_bank(n_mels=n_mels)  # (n_mels, 201)
    ranges = np.zeros((n_mels, 3), np.int32)
    runs = []
    for m in range(n_mels):
        nz = np.nonzero(fb[m])[0]
        first, count = (int(nz[0]), int(nz[-1] - nz[0] + 1)) if nz.size else (0, 0)
        ranges[m] = first, count, sum(r.size for r in runs)
        runs.append(fb[m, first:first + count])
    return ranges, np.concatenate(runs).astype(np.float32)


@functools.lru_cache(maxsize=8)
def _kernel_constants(device: torch.device, n_mels: int) -> tuple[torch.Tensor, ...]:
    """twiddles, window, ranges and weights on ``device``."""
    ranges, weights = sparse_filterbank(n_mels)
    return tuple(torch.from_numpy(a).to(device) for a in (
        twiddle_table(), hann_window_periodic(), ranges, weights))


def mel_energies_plain(audio: torch.Tensor, n_mels: int = 80) -> torch.Tensor:
    """Plain torch version of the kernel: (B, n) f32 -> (B, n/160, n_mels)
    mel energies, through the same padded basis and filterbank."""
    basis, fb = _constants(audio.device, n_mels)
    spec = interleaved_matmul(frame_audio(audio), basis)  # (B, T, 512)
    power = spec[..., :BINS_PAD] ** 2 + spec[..., BINS_PAD:] ** 2
    return power @ fb


def mel_energies(audio: torch.Tensor, n_mels: int = 80) -> torch.Tensor:
    """(B, n) f32 -> (B, n/160, n_mels) mel energies: the CUDA kernel for a
    CUDA tensor, the plain version for a CPU tensor."""
    if audio.device.type == "cpu":
        return mel_energies_plain(audio, n_mels)
    if audio.device.type != "cuda":
        raise ValueError(f"mel kernel: unsupported device {audio.device}")
    if audio.dtype != torch.float32 or audio.ndim != 2 or not audio.is_contiguous():
        raise ValueError("mel kernel takes contiguous (B, n_samples) float32 audio, "
                         f"got {tuple(audio.shape)} {audio.dtype}")
    b, n = audio.shape
    if n <= N_FFT // 2:
        raise ValueError(f"mel kernel: {n} samples is too short to reflect-pad")
    tw, win, ranges, weights = _kernel_constants(audio.device, n_mels)
    out = torch.empty((b, n // HOP_LENGTH, n_mels), dtype=torch.float32, device=audio.device)
    lib = _build.library("mel", _SIGNATURES)
    err = lib.wcb_mel(audio.data_ptr(), b, n, tw.data_ptr(), win.data_ptr(), ranges.data_ptr(),
                      weights.data_ptr(), n_mels, weights.numel(), out.data_ptr(),
                      _build.stream_handle(audio.device))
    _build.check(lib, err, "mel")
    _build.count_launch("mel")
    return out


def kernel_info(n_mels: int = 80) -> list[dict]:
    """``_build.kernel_info_row`` of the kernel at ``n_mels``."""
    lib = _build.library("mel", _SIGNATURES)
    nnz = sparse_filterbank(n_mels)[1].size
    return [_build.kernel_info_row(lib, lib.wcb_mel_info, (n_mels, nnz),
                                   f"mel ({n_mels} mels)", torch.float32)]


def log_mel_spectrogram_fused(audio: torch.Tensor, n_mels: int = 80) -> torch.Tensor:
    """Batched frontend: (B, 480000) f32 -> (B, n_mels, 3000) f32, through
    the kernel on a CUDA tensor; on a CPU tensor it is
    ``audio.mel.log_mel_spectrogram``."""
    if audio.ndim == 1:
        audio = audio[None]
    audio = audio.to(torch.float32).contiguous()
    return log_mel_tail(mel_energies(audio, n_mels))
