"""Model layer: configs, the Whisper modules and their functions, the
weight carry-over from the JAX package, and HF checkpoints in and out."""

from .alignment import (
    ALIGNMENT_HEADS,
    alignment_matrix,
    default_alignment_mask,
    heads_to_mask,
    infer_model_name,
    lookup_alignment_heads,
    resolve_alignment_mask,
)
from .config import FAST_OVERRIDES, WhisperConfig, get_config, tiny_test_config
from .convert import build_model, init_state_dict, params_from_jax, state_dict_to_jax
from .load_hf import (
    config_from_state_dict,
    load_checkpoint_or_safetensors,
    load_pretrained,
    load_safetensors,
    load_torch_model,
    params_from_state_dict,
    save_safetensors,
    state_dict_from_params,
)
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
    "ALIGNMENT_HEADS",
    "alignment_matrix",
    "default_alignment_mask",
    "heads_to_mask",
    "infer_model_name",
    "lookup_alignment_heads",
    "resolve_alignment_mask",
    "FAST_OVERRIDES",
    "WhisperConfig",
    "get_config",
    "tiny_test_config",
    "build_model",
    "init_state_dict",
    "params_from_jax",
    "state_dict_to_jax",
    "config_from_state_dict",
    "load_checkpoint_or_safetensors",
    "load_pretrained",
    "load_safetensors",
    "load_torch_model",
    "params_from_state_dict",
    "save_safetensors",
    "state_dict_from_params",
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
