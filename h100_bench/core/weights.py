"""Random Whisper weights from the seed, on the card, under the published
``WhisperForConditionalGeneration`` tensor names, and the renaming to the
port's keys.

One generator on the device draws every value in one call per storage
type; each tensor is a view of that draw, scaled in place: linear and conv
weights N(0, 1/fan_in), biases N(0, 0.02^2), layer-norm scales 1 + N(0,
0.05^2), the token and text-position embeddings N(0, 0.02^2) (the HF
init's std). The encoder's positions are the published sinusoids. The
token embedding is also the vocabulary projection (tied, as published).
"""

from __future__ import annotations

import math

import numpy as np
import torch


def geometry(cfg: dict) -> dict:
    """The sizes the benchmark computes with, from a configuration file."""
    return dict(d=cfg["d_model"], heads=cfg["encoder_attention_heads"],
                enc_layers=cfg["encoder_layers"], dec_layers=cfg["decoder_layers"],
                ffn=cfg["encoder_ffn_dim"], n_mels=cfg["num_mel_bins"],
                vocab=cfg["vocab_size"], t_audio=cfg["max_source_positions"],
                t_text=cfg["max_target_positions"])


def hf_shapes(g: dict) -> dict[str, tuple]:
    """Every tensor of the published model, by its HF name, in a fixed
    order."""
    d, f = g["d"], g["ffn"]
    s: dict[str, tuple] = {
        "model.encoder.conv1.weight": (d, g["n_mels"], 3), "model.encoder.conv1.bias": (d,),
        "model.encoder.conv2.weight": (d, d, 3), "model.encoder.conv2.bias": (d,),
        "model.encoder.embed_positions.weight": (g["t_audio"], d)}

    def attn(p):
        for n in ("q", "k", "v", "out"):
            s[f"{p}.{n}_proj.weight"] = (d, d)
            if n != "k":
                s[f"{p}.{n}_proj.bias"] = (d,)

    def ln(p):
        s[f"{p}.weight"], s[f"{p}.bias"] = (d,), (d,)

    def mlp(p):
        s[f"{p}.fc1.weight"], s[f"{p}.fc1.bias"] = (f, d), (f,)
        s[f"{p}.fc2.weight"], s[f"{p}.fc2.bias"] = (d, f), (d,)

    for i in range(g["enc_layers"]):
        p = f"model.encoder.layers.{i}"
        attn(f"{p}.self_attn")
        ln(f"{p}.self_attn_layer_norm")
        mlp(p)
        ln(f"{p}.final_layer_norm")
    ln("model.encoder.layer_norm")
    s["model.decoder.embed_tokens.weight"] = (g["vocab"], d)
    s["model.decoder.embed_positions.weight"] = (g["t_text"], d)
    for i in range(g["dec_layers"]):
        p = f"model.decoder.layers.{i}"
        attn(f"{p}.self_attn")
        ln(f"{p}.self_attn_layer_norm")
        attn(f"{p}.encoder_attn")
        ln(f"{p}.encoder_attn_layer_norm")
        mlp(p)
        ln(f"{p}.final_layer_norm")
    ln("model.decoder.layer_norm")
    return s


def sinusoids(length: int, channels: int) -> np.ndarray:
    """The published encoder positions."""
    inc = np.log(10000) / (channels // 2 - 1)
    inv = np.exp(-inc * np.arange(channels // 2))
    t = np.arange(length)[:, None] * inv[None, :]
    return np.concatenate([np.sin(t), np.cos(t)], axis=1).astype(np.float32)


def _kind(name: str) -> str:
    if name.endswith("embed_positions.weight") and ".encoder." in name:
        return "sinusoid"
    if "layer_norm" in name:
        return "ln_scale" if name.endswith("weight") else "bias"
    if name.endswith("bias"):
        return "bias"
    if "embed" in name:
        return "embedding"
    return "matrix"


def make_weights(g: dict, seed: int, device, dtype=torch.float32
                 ) -> tuple[dict[str, torch.Tensor], torch.Tensor]:
    """Every tensor of the model, from ``seed``, as views of one draw of
    ``dtype`` values on ``device``; and that draw."""
    shapes = hf_shapes(g)
    total = sum(math.prod(v) for v in shapes.values())
    gen = torch.Generator(device=device).manual_seed(seed % (2 ** 63))
    flat = torch.randn(total, generator=gen, device=device, dtype=dtype)
    out, off = {}, 0
    for name, shape in shapes.items():
        n = math.prod(shape)
        t = flat[off:off + n].view(shape)
        off += n
        kind = _kind(name)
        if kind == "matrix":
            fan_in = shape[1] * (shape[2] if len(shape) == 3 else 1)
            t.mul_(1.0 / math.sqrt(fan_in))
        elif kind == "ln_scale":
            t.mul_(0.05).add_(1.0)
        elif kind in ("bias", "embedding"):
            t.mul_(0.02)
        else:
            t.copy_(torch.from_numpy(sinusoids(*shape)))
        out[name] = t
    return out, flat


_ATTN = {"q_proj": "query", "k_proj": "key", "v_proj": "value", "out_proj": "out"}


def port_name(hf: str) -> str:
    """The port's state-dict key of an HF tensor name."""
    n = hf.removeprefix("model.")
    fixed = {"encoder.embed_positions.weight": "encoder.pos_emb",
             "encoder.layer_norm.weight": "encoder.ln_post.weight",
             "encoder.layer_norm.bias": "encoder.ln_post.bias",
             "decoder.embed_tokens.weight": "decoder.token_emb",
             "decoder.embed_positions.weight": "decoder.pos_emb",
             "decoder.layer_norm.weight": "decoder.ln.weight",
             "decoder.layer_norm.bias": "decoder.ln.bias"}
    if n in fixed:
        return fixed[n]
    parts = n.split(".")
    if parts[1] != "layers":
        return n  # the conv stem keeps its names
    side, i, rest = parts[0], parts[2], parts[3:]
    grp = {"self_attn": "self_attn" if side == "decoder" else "attn",
           "encoder_attn": "cross_attn",
           "self_attn_layer_norm": "self_attn_ln" if side == "decoder" else "attn_ln",
           "encoder_attn_layer_norm": "cross_attn_ln", "final_layer_norm": "mlp_ln",
           "fc1": "mlp.fc1", "fc2": "mlp.fc2"}[rest[0]]
    tail = [_ATTN.get(x, x) for x in rest[1:]]
    return ".".join([side, "blocks", i, grp, *tail])


def to_port(weights: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    return {port_name(k): v for k, v in weights.items()}
