"""Explicit FLOPs model for Whisper: the MFU accounting of the benchmarks.
A copy of the JAX package's ``utils/flops.py``; the peak table names the
H100, and ``device_peak_flops`` reads the card's name from torch.

Counts matmul FLOPs only (2 x MACs: every multiply-add is 2 FLOPs), the
convention used by MFU reporting everywhere (PaLM appendix B); elementwise
work (layernorm, gelu, softmax scaling) is excluded. The backward pass is
counted as 2x the forward matmuls (each matmul contributes dX and dW).

All functions return FLOPs **per example row** unless stated otherwise; the
benchmarks multiply by batch and grad-accumulation themselves.

Reference geometry (models/config.py): encoder conv stem (k=3 stride 1,
then k=3 stride 2) maps 2*n_audio_ctx mel frames -> n_audio_ctx states;
decoder is causal self-attention + full cross-attention over those states;
the logits projection ties the token embedding (2*S*d*V forward).
"""

from __future__ import annotations

import os


def mel_flops(cfg, n_frames: int | None = None) -> float:
    """Matmul-STFT log-mel frontend (ops/mel_kernel.py): framed DFT as one
    (frames, n_fft) x (n_fft, 2*(n_fft/2+1)) matmul + the mel filterbank
    projection. Small next to the encoder (~1% at 30 s) but part of the
    benched program."""
    frames = 2 * cfg.n_audio_ctx if n_frames is None else n_frames
    n_fft = 400
    bins = n_fft // 2 + 1
    dft = 2.0 * frames * n_fft * (2 * bins)
    mel = 2.0 * frames * bins * cfg.n_mels
    return dft + mel


def encoder_flops(cfg, n_frames: int | None = None) -> float:
    """Encoder forward per row. ``n_frames`` = mel frames (3000 for the full
    30 s window; bucketed serving scales it down), giving T = n_frames // 2
    attention states."""
    frames = 2 * cfg.n_audio_ctx if n_frames is None else n_frames
    t = frames // 2
    d = cfg.d_model
    conv1 = 2.0 * frames * d * (3 * cfg.n_mels)
    conv2 = 2.0 * t * d * (3 * d)
    # per layer: QKV (6Td^2) + out (2Td^2) + MLP (16Td^2) + scores/values (4T^2 d)
    per_layer = 24.0 * t * d * d + 4.0 * t * t * d
    return conv1 + conv2 + cfg.n_audio_layers * per_layer


def decoder_train_flops(cfg, seq: int) -> float:
    """Decoder forward per row at full label length ``seq`` (training /
    teacher-forced scoring), including the cross-attention KV projection of
    the encoder states and the logits projection."""
    s, t = seq, cfg.n_audio_ctx
    d = cfg.d_model
    per_layer = (
        28.0 * s * d * d      # self QKV+out, cross Q+out, MLP
        + 4.0 * t * d * d     # cross K/V projection of encoder states
        + 4.0 * s * s * d     # causal self-attention scores + values
        + 4.0 * s * t * d     # cross-attention scores + values
    )
    logits = 2.0 * s * d * cfg.n_vocab
    return cfg.n_text_layers * per_layer + logits


def train_step_flops(cfg, batch: int, seq: int, grad_accum: int = 1,
                     freeze_encoder: bool = False) -> float:
    """Total FLOPs of one optimizer step (all microbatches, fwd + bwd).
    Backward = 2x forward; a frozen encoder runs forward only."""
    enc = encoder_flops(cfg) * (1.0 if freeze_encoder else 3.0)
    dec = decoder_train_flops(cfg, seq) * 3.0
    return (enc + dec) * batch * grad_accum


def decode_flops(cfg, new_tokens: int, prefill: int = 1,
                 n_frames: int | None = None,
                 include_mel: bool = True) -> float:
    """Greedy decode forward per row: encoder + cross-KV precompute +
    teacher-forced prefill + ``new_tokens`` cached single-token steps.
    The self-attention cache term uses the mean cache length."""
    d = cfg.d_model
    t = (2 * cfg.n_audio_ctx if n_frames is None else n_frames) // 2
    total = encoder_flops(cfg, n_frames)
    if include_mel:
        total += mel_flops(cfg, n_frames)
    total += cfg.n_text_layers * 4.0 * t * d * d   # cross K/V precompute
    # prefill: teacher-forced pass without the cross-KV term (precomputed)
    s = prefill
    total += cfg.n_text_layers * (28.0 * s * d * d + 4.0 * s * s * d
                                 + 4.0 * s * t * d)
    total += 2.0 * s * d * cfg.n_vocab
    # per generated token: projections on one position + attention reads
    mean_cache = prefill + (new_tokens + 1) / 2.0
    per_tok = cfg.n_text_layers * (28.0 * d * d + 4.0 * mean_cache * d
                                  + 4.0 * t * d) + 2.0 * d * cfg.n_vocab
    return total + new_tokens * per_tok


_PEAK_BF16_TFLOPS = {
    # published dense bf16 peaks per card (no sparsity), by the name torch
    # reports: NVIDIA's H100 datasheet, SXM part, at its 700 W limit
    "NVIDIA H100 80GB HBM3": 989.0,
}

# the card this repository measures on: the figure kernel bounds use
H100_BF16_FLOPS = _PEAK_BF16_TFLOPS["NVIDIA H100 80GB HBM3"] * 1e12


def device_peak_flops(device=None) -> float | None:
    """Per-card bf16 peak in FLOP/s for MFU math. Override with
    BENCH_PEAK_TFLOPS; returns None for unknown cards and for the CPU (test
    runs). ``device``: a CUDA ``torch.device`` or index (the current card by
    default)."""
    env = os.environ.get("BENCH_PEAK_TFLOPS")
    if env:
        return float(env) * 1e12
    import torch

    if device is None:
        if not torch.cuda.is_available():
            return None
        device = torch.cuda.current_device()
    if isinstance(device, torch.device) and device.type != "cuda":
        return None
    kind = torch.cuda.get_device_name(device)
    for name, tf in _PEAK_BF16_TFLOPS.items():
        if kind.startswith(name):
            return tf * 1e12
    return None
