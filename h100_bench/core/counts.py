"""The benchmark's yardstick of work: matmul FLOPs of a Whisper pass, the
operations and bytes of each hand-written kernel launch, the card's peaks.

Counts are the least work the mathematics needs at the call's shapes:
every multiply-add is 2 FLOPs, each input byte is read once and each
output byte written once. The FLOP model is the program's own
(``utils/flops.py``) copied here so that a change to the program cannot
move the yardstick; the log-mel frontend is left out of it (the program
computes it by FFT, not by a matmul). The kernels' counts follow the
arithmetic of ``chip_smoke.py``.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense (no sparsity), at the 700 W limit
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_S = 3.35e12
# NVLink 4 of the H100 SXM: 900 GB/s both ways, 450 GB/s a direction
PEAK_NVLINK_BYTES_S = 450e9


# ---------------------------------------------------------------------------
# matmul FLOPs of the model (per row)
# ---------------------------------------------------------------------------

def encoder_flops(g: dict) -> float:
    """Encoder forward of one 30 s window: the conv stem, then per layer
    QKV + out (8 T d^2), the MLP (16 T d^2) and scores + values (4 T^2 d)."""
    t, d = g["t_audio"], g["d"]
    frames = 2 * t
    conv = 2.0 * frames * d * 3 * g["n_mels"] + 2.0 * t * d * 3 * d
    return conv + g["enc_layers"] * (24.0 * t * d * d + 4.0 * t * t * d)


def cross_kv_flops(g: dict) -> float:
    """The cross-attention K and V of every decoder layer from the encoder
    states."""
    return g["dec_layers"] * 4.0 * g["t_audio"] * g["d"] ** 2


def decoder_tokens_flops(g: dict, s: int, ctx: float) -> float:
    """Decoder forward of ``s`` query positions that attend to ``ctx``
    self-attention keys on average, with the cross K/V already made:
    self QKV + out, cross Q + out, MLP (28 s d^2), self scores + values
    (4 s ctx d), cross scores + values (4 s T d), and the vocabulary
    product (2 s d V)."""
    d, t = g["d"], g["t_audio"]
    per_layer = 28.0 * s * d * d + 4.0 * s * ctx * d + 4.0 * s * t * d
    return g["dec_layers"] * per_layer + 2.0 * s * d * g["vocab"]


def serve_row_flops(g: dict, prefix: int, served: int) -> float:
    """One request of greedy decoding: the encoder, the cross K/V, the
    prefill of the ``prefix`` tokens (causal: (prefix + 1) / 2 keys each)
    and ``served`` cached steps, step i attending to prefix + i keys."""
    pre = decoder_tokens_flops(g, prefix, (prefix + 1) / 2.0)
    steps = decoder_tokens_flops(g, served, prefix + (served + 1) / 2.0) if served else 0.0
    return encoder_flops(g) + cross_kv_flops(g) + pre + steps


def train_row_flops(g: dict, seq: int) -> float:
    """One row of a training step at decoder length ``seq``: forward, and a
    backward of twice the forward; remat's recompute is not counted."""
    fwd = encoder_flops(g) + cross_kv_flops(g) + decoder_tokens_flops(g, seq, (seq + 1) / 2.0)
    return 3.0 * fwd


# ---------------------------------------------------------------------------
# kernels: (operations, bytes) of one launch
# ---------------------------------------------------------------------------

def _pairs(tq: int, tk: int, causal: bool) -> float:
    """Query-key pairs a head computes: all, or the lower triangle."""
    return tq * (tq + 1) / 2.0 if causal else float(tq) * tk


def flash_fwd_work(b: int, h: int, tq: int, tk: int, dh: int, causal: bool,
                   elem: int = 2) -> tuple[float, float]:
    """K2: scores and values (4 dh a pair); reads q, k, v, writes o and the
    f32 logsumexp."""
    ops = 4.0 * b * h * dh * _pairs(tq, tk, causal)
    n_bytes = elem * b * h * dh * (2 * tq + 2 * tk) + 4.0 * b * h * tq
    return ops, n_bytes


def flash_bwd_work(b: int, h: int, tq: int, tk: int, dh: int, causal: bool,
                   elem: int = 2) -> tuple[float, float]:
    """K4: the five products of the attention backward (10 dh a pair);
    reads q, k, v, o, do and the logsumexp, writes dq, dk, dv."""
    ops = 10.0 * b * h * dh * _pairs(tq, tk, causal)
    n_bytes = elem * b * h * dh * (4 * tq + 4 * tk) + 4.0 * b * h * tq
    return ops, n_bytes


def quant_cross_work(b: int, t: int, t_pad: int, d: int, elem: int = 2) -> tuple[float, float]:
    """K3, one decode step of one layer: the int8 K and V rows of the ``t``
    real positions, the f32 scales of all ``t_pad``, q in and the output
    out; scores and values 4 T d."""
    ops = 4.0 * b * t * d
    n_bytes = 2.0 * b * t * d + 2 * 4.0 * b * t_pad + 2 * elem * b * d
    return ops, n_bytes


def allreduce_bound_s(values: int, elem: int = 4) -> float:
    """The least time of an all-reduce of ``values`` numbers over cards
    joined all to all: whatever the algorithm, a card sends its buffer
    once and receives the sum once, N bytes each way, at NVLink's rate a
    direction. (A ring moves 2 (n - 1) / n N each way and so reads at most
    n / (2 (n - 1)) of this bound, 67% on four cards; a reduction inside
    the switch can reach it.)"""
    return elem * float(values) / PEAK_NVLINK_BYTES_S


def bound_s(ops: float, n_bytes: float, peak_flops: float = PEAK_BF16_FLOPS) -> float:
    """The least time a launch can take: the larger of its operations over
    the peak and its bytes over the memory bandwidth."""
    return max(ops / peak_flops, n_bytes / PEAK_BYTES_S)
