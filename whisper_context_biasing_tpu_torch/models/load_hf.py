"""HF Whisper checkpoints in and out: the counterpart of the JAX package's
``models/load_hf.py``, under its names.

Converts HuggingFace Whisper weights (the format the reference trains in,
``WhisperForConditionalGeneration``) to and from the port's state dict:

  * a ``model.safetensors`` file, read and written by the port's own code
    (``models/safetensors_io.py``; no ``safetensors`` package)
  * an in-memory state dict of numpy arrays or a torch HF model (the parity
    tests build one locally from a config)

HF and the port both store linear weights (out, in) and conv weights
(O, I, W), so the map is a renaming with no transposes: ``embed_positions``
-> ``pos_emb``, ``embed_tokens`` -> ``token_emb``, ``layers.{i}`` ->
``blocks.{i}``, ``{q,k,v,out}_proj`` -> ``{query,key,value,out}``,
``encoder_attn`` -> ``cross_attn``, the layer norms to their names here. An
untied ``proj_out`` is kept only when it differs from the token embedding.
"""

from __future__ import annotations

import os
import re
from dataclasses import replace

import numpy as np
import torch

from .config import WhisperConfig, get_config
from .convert import init_state_dict
from .safetensors_io import read_safetensors, write_safetensors
from .whisper import Whisper

_LN = {"attn_ln": "self_attn_layer_norm", "self_attn_ln": "self_attn_layer_norm",
       "cross_attn_ln": "encoder_attn_layer_norm", "mlp_ln": "final_layer_norm"}
_ATTN = {"attn": "self_attn", "self_attn": "self_attn", "cross_attn": "encoder_attn"}
_PROJ = {"query": "q_proj", "key": "k_proj", "value": "v_proj", "out": "out_proj"}
_TOP = {"pos_emb": "embed_positions.weight", "token_emb": "embed_tokens.weight",
        "ln_post": "layer_norm", "ln": "layer_norm"}


def _hf_name(name: str) -> str:
    """The port's parameter name -> the HF name without the ``model.``
    prefix (``proj_out`` -> ``proj_out.weight``)."""
    if name == "proj_out":
        return "proj_out.weight"
    side, mod, *rest = name.split(".")
    if mod == "blocks":
        i, sub, *rest = rest
        if sub in _ATTN:
            return f"{side}.layers.{i}.{_ATTN[sub]}.{_PROJ[rest[0]]}.{rest[1]}"
        if sub == "mlp":
            return f"{side}.layers.{i}.{'.'.join(rest)}"
        return f"{side}.layers.{i}.{_LN[sub]}.{'.'.join(rest)}"
    if mod in _TOP:
        return ".".join([side, _TOP[mod], *rest])
    return name  # conv1, conv2


def _port_names(cfg: WhisperConfig) -> list[str]:
    with torch.device("meta"):
        return list(Whisper(cfg).state_dict())


def _strip_prefix(sd: dict) -> dict:
    """Drop the 'model.' prefix used by WhisperForConditionalGeneration."""
    return {k[6:] if k.startswith("model.") else k: v for k, v in sd.items()}


def config_from_state_dict(sd: dict) -> WhisperConfig:
    sd = _strip_prefix(sd)
    d = sd["decoder.embed_tokens.weight"].shape[1]
    vocab = sd["decoder.embed_tokens.weight"].shape[0]
    n_mels = sd["encoder.conv1.weight"].shape[1]

    def n_layers(side):
        return 1 + max(int(m.group(1)) for k in sd
                       if (m := re.match(side + r"\.layers\.(\d+)\.", k)))

    # head count is not recoverable from the weights alone; every public
    # Whisper model uses head_dim=64 — pass an explicit cfg for other dims
    head_dim = 64
    return WhisperConfig(
        n_mels=n_mels, d_model=d, n_heads=max(1, d // head_dim),
        n_audio_layers=n_layers("encoder"), n_text_layers=n_layers("decoder"),
        n_vocab=vocab, multilingual=vocab != 51864,
        # context windows come from the positional tables, not defaults, so
        # a fine-tune with a longer decoder context is not truncated
        n_audio_ctx=sd["encoder.embed_positions.weight"].shape[0],
        n_text_ctx=sd["decoder.embed_positions.weight"].shape[0],
    )


def params_from_state_dict(sd: dict, cfg: WhisperConfig | None = None
                           ) -> tuple[dict[str, torch.Tensor], WhisperConfig]:
    """HF state dict -> (the port's state dict, cfg); ``cfg`` is inferred
    from the weights when not given. The tensors keep the file's float
    dtype (f32 for every public checkpoint); ``build_model`` casts them."""
    sd = _strip_prefix(sd)
    if cfg is None:
        cfg = config_from_state_dict(sd)
    # copies that own their memory, in the file's dtype
    out = {name: torch.from_numpy(np.array(sd[_hf_name(name)])) for name in _port_names(cfg)}
    if "proj_out.weight" in sd:
        proj = np.asarray(sd["proj_out.weight"])
        if not np.array_equal(proj, np.asarray(sd["decoder.embed_tokens.weight"])):
            out["proj_out"] = torch.from_numpy(np.array(proj))  # untied head
    return out, cfg


def state_dict_from_params(state_dict: dict, cfg: WhisperConfig) -> dict[str, np.ndarray]:
    """The inverse of :func:`params_from_state_dict`: the port's state dict
    -> an HF ``WhisperForConditionalGeneration`` state dict of contiguous
    numpy float32 arrays, keys prefixed with ``model.``, plus
    ``proj_out.weight`` (the token embedding when the head is tied).
    Quantized (int8) weights are not exportable, as in the JAX package."""
    if any(v.dtype == torch.int8 for v in state_dict.values()):
        raise ValueError("quantized (int8) params are not exportable — dequantize or export "
                         "the float master copy")

    def put(t):
        return np.ascontiguousarray(t.detach().float().cpu().numpy(), dtype=np.float32)

    out = {"model." + _hf_name(name): put(state_dict[name]) for name in _port_names(cfg)}
    out["proj_out.weight"] = put(state_dict.get("proj_out", state_dict["decoder.token_emb"]))
    return out


def save_safetensors(state_dict: dict, cfg: WhisperConfig, path: str) -> None:
    """Write an HF-compatible ``model.safetensors`` (directory or file path)."""
    if os.path.isdir(path) or not path.endswith(".safetensors"):
        os.makedirs(path, exist_ok=True)
        path = os.path.join(path, "model.safetensors")
    elif os.path.dirname(path):
        os.makedirs(os.path.dirname(path), exist_ok=True)
    write_safetensors(state_dict_from_params(state_dict, cfg), path)


def load_safetensors(path: str, cfg: WhisperConfig | None = None
                     ) -> tuple[dict[str, torch.Tensor], WhisperConfig]:
    """Load an HF whisper checkpoint directory or .safetensors file."""
    if os.path.isdir(path):
        path = os.path.join(path, "model.safetensors")
    return params_from_state_dict(read_safetensors(path), cfg)


def load_torch_model(model, cfg: WhisperConfig | None = None
                     ) -> tuple[dict[str, torch.Tensor], WhisperConfig]:
    """Convert an in-memory torch WhisperModel/ForConditionalGeneration."""
    sd = {k: v.detach().cpu().numpy() for k, v in model.state_dict().items()}
    if cfg is None and hasattr(model, "config"):
        hf = model.config
        cfg = WhisperConfig(
            n_mels=hf.num_mel_bins, d_model=hf.d_model,
            n_heads=hf.encoder_attention_heads,
            n_audio_layers=hf.encoder_layers, n_text_layers=hf.decoder_layers,
            n_vocab=hf.vocab_size, n_text_ctx=hf.max_target_positions,
            multilingual=hf.vocab_size != 51864,
        )
    return params_from_state_dict(sd, cfg)


def load_checkpoint_or_safetensors(path: str, cfg: WhisperConfig | None = None):
    """Load either a native checkpoint-N dir (npz) or an HF safetensors
    checkpoint; returns (state dict, cfg)."""
    from ..train.checkpoint import is_native_checkpoint, load_checkpoint

    if is_native_checkpoint(path):
        if cfg is None:
            raise ValueError("cfg required when loading a native checkpoint")
        state_dict, _, _ = load_checkpoint(path, cfg)
        return state_dict, cfg
    return load_safetensors(path, cfg)


def load_pretrained(name_or_path: str, **overrides
                    ) -> tuple[dict[str, torch.Tensor], WhisperConfig]:
    """A local checkpoint path loads it; a model name resolves to its config
    with the port's seeded init (seed 0), as the JAX package gives its
    ``init_params``: nothing is fetched. ``overrides`` (dtype, kernel
    switches, ...) apply in both branches."""
    if os.path.exists(name_or_path):
        state_dict, cfg = load_safetensors(name_or_path)
        return state_dict, replace(cfg, **overrides) if overrides else cfg
    cfg = get_config(name_or_path.split("/")[-1].replace("whisper-", ""), **overrides)
    return init_state_dict(cfg), cfg
