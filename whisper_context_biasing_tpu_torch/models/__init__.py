"""Model layer: configs, the Whisper modules and their functions, and the
weight carry-over from the JAX package."""

from .config import FAST_OVERRIDES, WhisperConfig, get_config, tiny_test_config
from .convert import build_model, init_state_dict, params_from_jax, state_dict_to_jax
from .whisper import (
    Whisper,
    attention,
    decode_tokens,
    encode_audio,
    forward,
    init_kv_cache,
    layer_norm,
    precompute_cross_kv,
    project_vocab,
    quantize_cross_kv,
)

__all__ = [
    "FAST_OVERRIDES",
    "WhisperConfig",
    "get_config",
    "tiny_test_config",
    "build_model",
    "init_state_dict",
    "params_from_jax",
    "state_dict_to_jax",
    "Whisper",
    "attention",
    "decode_tokens",
    "encode_audio",
    "forward",
    "init_kv_cache",
    "layer_norm",
    "precompute_cross_kv",
    "project_vocab",
    "quantize_cross_kv",
]
