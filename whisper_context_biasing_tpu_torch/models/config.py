"""Whisper architecture configurations (public model family dimensions).

The same family table and test config as the JAX package's
``models/config.py``; the compute dtype resolves to a torch dtype, and the
kernel switches name the port's hand-written CUDA kernels.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import torch


@dataclass(frozen=True)
class WhisperConfig:
    n_mels: int = 80
    n_audio_ctx: int = 1500
    d_model: int = 512
    n_heads: int = 8
    n_audio_layers: int = 6
    n_text_layers: int = 6
    n_vocab: int = 51864
    n_text_ctx: int = 448
    multilingual: bool = False
    # compute dtype for block matmuls; layer norms, softmax and the vocab
    # logits stay f32
    dtype: str = "bfloat16"
    # encoder self-attention through the flash kernels
    # (ops/flash_attention.py, forward and backward); False runs
    # models.whisper.attention
    flash_attention: bool = False
    # flash attention in the decoder's full-sequence (training) mode too:
    # causal self-attention and cross-attention, when flash_attention is on
    flash_decoder: bool = True
    # label length below which the full-sequence decoder keeps the plain
    # attention even with flash_decoder (tests set 0 to reach the kernels)
    flash_decoder_min_seq: int = 256
    # rematerialization of transformer blocks in training (the JAX
    # package's policies):
    #   "full" - torch.utils.checkpoint per block, recompute it in backward
    #   "dots" - selective checkpointing: keep the outputs of products
    #            without batch dims, recompute the rest
    #   "wide" - keep everything but the 4*d-wide MLP tensors (fc1 + gelu
    #            rerun)
    #   "none" - keep every activation
    remat: str = "full"
    # int8 cross-attention K/V for decode (models/whisper.py:quantize_cross_kv)
    quantize_cross_kv: bool = False
    # single-query int8 cross-attention kernel for the decode step
    # (ops/quant_cross_attention.py); needs quantize_cross_kv. False runs the
    # plain models.whisper._attention_quant_cross
    fused_quant_cross: bool = False
    # tanh-approximate gelu instead of exact erf (the serving fast path)
    gelu_approx: bool = False
    # fused LayerNorm+matmul kernel (ops/fused_block.py) for the
    # pre-attention LN + QKV projection (and the cross-attention query), and
    # for the pre-MLP LN + first MLP matmul + gelu. The encoder and the
    # full-sequence (training) decoder use them; the cached single-token
    # decode path keeps the unfused ops either way. In bf16 the fused config
    # adds the bias before rounding, so it is not the unfused function
    fused_ln_qkv: bool = False
    fused_ln_mlp: bool = False

    def __post_init__(self):
        if self.remat not in ("full", "dots", "wide", "none"):
            raise ValueError(f"unknown remat policy {self.remat!r}")

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def compute_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    # reference-parity aliases (HF WhisperConfig names used by the reference)
    @property
    def vocab_size(self) -> int:
        return self.n_vocab

    @property
    def max_target_positions(self) -> int:
        return self.n_text_ctx

    @property
    def decoder_start_token_id(self) -> int:
        return 50258 if self.multilingual else 50257

    @property
    def pad_token_id(self) -> int:
        """<|endoftext|>: the label pad, and the lowest special-token id."""
        return 50257 if self.multilingual else 50256

    @property
    def eos_token_id(self) -> int:
        return self.pad_token_id


# the serving fast path (the JAX package's Pipeline(fast=True)): the
# flash-attention and int8 cross-attention kernels, int8 cross-K/V and tanh
# gelu (the mel kernel is chosen by device, audio.mel.select_mel_frontend)
FAST_OVERRIDES = {
    "flash_attention": True,
    "quantize_cross_kv": True,
    "fused_quant_cross": True,
    "gelu_approx": True,
}

_FAMILY = {
    # name: (d_model, n_heads, n_audio_layers, n_text_layers)
    "tiny": (384, 6, 4, 4),
    "base": (512, 8, 6, 6),
    "small": (768, 12, 12, 12),
    "medium": (1024, 16, 24, 24),
    "large": (1280, 20, 32, 32),
    "large-v2": (1280, 20, 32, 32),
    "large-v3": (1280, 20, 32, 32),
    "large-v3-turbo": (1280, 20, 32, 4),
    "distil-small": (768, 12, 12, 4),
    "distil-medium": (1024, 16, 24, 2),
    "distil-large-v2": (1280, 20, 32, 2),
    "distil-large-v3": (1280, 20, 32, 2),
}


def get_config(name: str, **overrides) -> WhisperConfig:
    """``get_config("base.en")``, ``get_config("large-v3")`` etc."""
    base = name
    english = name.endswith(".en")
    if english:
        base = name[: -len(".en")]
    if base not in _FAMILY:
        raise ValueError(f"unknown whisper model: {name!r} (know {sorted(_FAMILY)})")
    # the large-v3 lineage rules (128 mels, 51866 vocab) apply to the
    # distilled variants of the same teachers
    stem = base[len("distil-"):] if base.startswith("distil-") else base
    if english and stem.startswith("large"):
        raise ValueError(f"no English-only variant of {base!r}")
    if not english and base in ("distil-small", "distil-medium"):
        raise ValueError(f"{base!r} ships English-only: use {base}.en")
    d, h, audio_layers, text_layers = _FAMILY[base]
    if english:
        vocab = 51864
    elif stem.startswith("large-v3"):
        vocab = 51866
    else:
        vocab = 51865
    cfg = WhisperConfig(
        n_mels=128 if stem.startswith("large-v3") else 80,
        d_model=d,
        n_heads=h,
        n_audio_layers=audio_layers,
        n_text_layers=text_layers,
        n_vocab=vocab,
        multilingual=not english,
    )
    return replace(cfg, **overrides)


def tiny_test_config(**overrides) -> WhisperConfig:
    """A miniature config for fast CPU tests."""
    cfg = WhisperConfig(
        n_mels=80, n_audio_ctx=64, d_model=64, n_heads=2,
        n_audio_layers=2, n_text_layers=2, n_vocab=51864, n_text_ctx=448,
        dtype="float32",
    )
    return replace(cfg, **overrides)
