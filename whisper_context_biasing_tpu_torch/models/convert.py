"""Weights for the port: carried over from the JAX package, or a seeded init.

``params_from_jax`` maps the JAX params tree, as numpy arrays, onto the
port's state dict, and ``state_dict_to_jax`` maps a state dict (or a dict of
gradients keyed by parameter name) back. The JAX tree stacks each block parameter over layers
(L, ...), stores linear weights (in, out) and conv weights (W, I, O)
(the JAX package's ``models/whisper.py``); the port keeps one module per
block, ``nn.Linear`` weights (out, in) and ``nn.Conv1d`` weights (O, I, W).
The token embedding is also the (tied) vocab projection, unless the tree
holds an untied ``proj_out`` (V, D): then the model gets one too, under the
same name. A tree from the JAX package's ``quantize_decoder_weights`` holds
``{"q", "s"}`` int8 leaves for the decoder: they carry over as int8 weights
with their scales (``models/whisper.py:int8_decoder_layout``), which
``build_model`` gives a decode-only model.

``init_state_dict`` draws the same distributions as the JAX package's
``init_params`` from a ``torch.Generator``: the numbers differ from JAX's for
the same seed, but a seed gives the same weights on every machine.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .._device import resolve_device
from .config import WhisperConfig
from .whisper import Whisper, int8_decoder_layout, sinusoids

_ATTN = {"query": ("wq", "bq"), "key": ("wk", None), "value": ("wv", "bv"),
         "out": ("wo", "bo")}
_MLP = {"fc1": ("w1", "b1"), "fc2": ("w2", "b2")}


def params_from_jax(np_tree: dict, cfg: WhisperConfig) -> dict[str, torch.Tensor]:
    """JAX params tree (numpy leaves) -> the port's state dict (f32, CPU)."""
    def t(a) -> torch.Tensor:
        return torch.from_numpy(np.array(a, dtype=np.float32))

    def q8(a) -> torch.Tensor:
        return torch.from_numpy(np.array(a, dtype=np.int8))

    def rows(sd, name, leaf):
        if isinstance(leaf, dict):  # int8 rows (V, D), scales (V, 1)
            sd[name], sd[f"{name}_scale"] = q8(leaf["q"]), t(leaf["s"])
        else:
            sd[name] = t(leaf)

    def lin(sd, prefix, group, i, names):
        for mod, (w, b) in names.items():
            if isinstance(group[w], dict):  # int8 (in, out), scales (1, out) a layer
                sd[f"{prefix}.{mod}.weight"] = q8(group[w]["q"][i]).T.contiguous()
                sd[f"{prefix}.{mod}.scale"] = t(group[w]["s"][i])[0]
            else:
                sd[f"{prefix}.{mod}.weight"] = t(group[w][i]).T.contiguous()
            if b is not None:
                sd[f"{prefix}.{mod}.bias"] = t(group[b][i])

    def ln(sd, prefix, group, i=None):
        sd[f"{prefix}.weight"] = t(group["scale"] if i is None else group["scale"][i])
        sd[f"{prefix}.bias"] = t(group["bias"] if i is None else group["bias"][i])

    enc, dec = np_tree["encoder"], np_tree["decoder"]
    sd: dict[str, torch.Tensor] = {}
    for c in ("conv1", "conv2"):
        sd[f"encoder.{c}.weight"] = t(enc[c]["w"]).permute(2, 1, 0).contiguous()
        sd[f"encoder.{c}.bias"] = t(enc[c]["b"])
    sd["encoder.pos_emb"] = t(enc["pos_emb"])
    for i in range(cfg.n_audio_layers):
        p = f"encoder.blocks.{i}"
        ln(sd, f"{p}.attn_ln", enc["attn_ln"], i)
        lin(sd, f"{p}.attn", enc["attn"], i, _ATTN)
        ln(sd, f"{p}.mlp_ln", enc["mlp_ln"], i)
        lin(sd, f"{p}.mlp", enc["mlp"], i, _MLP)
    ln(sd, "encoder.ln_post", enc["ln_post"])

    rows(sd, "decoder.token_emb", dec["token_emb"])
    sd["decoder.pos_emb"] = t(dec["pos_emb"])
    for i in range(cfg.n_text_layers):
        p = f"decoder.blocks.{i}"
        for name in ("self_attn", "cross_attn"):
            ln(sd, f"{p}.{name}_ln", dec[f"{name}_ln"], i)
            lin(sd, f"{p}.{name}", dec[name], i, _ATTN)
        ln(sd, f"{p}.mlp_ln", dec["mlp_ln"], i)
        lin(sd, f"{p}.mlp", dec["mlp"], i, _MLP)
    ln(sd, "decoder.ln", dec["ln"])
    if "proj_out" in np_tree:
        rows(sd, "proj_out", np_tree["proj_out"])
    return sd


def state_dict_to_jax(sd: dict, cfg: WhisperConfig) -> dict:
    """The port's state dict (or gradients keyed by parameter name) -> the
    JAX params tree with numpy f32 leaves: the inverse of ``params_from_jax``."""

    def a(name) -> np.ndarray:
        return sd[name].detach().float().cpu().numpy()

    def stack(prefix, n, suffix, transpose=False):
        return np.stack([a(f"{prefix}.{i}.{suffix}").T if transpose
                         else a(f"{prefix}.{i}.{suffix}") for i in range(n)])

    def ln(prefix, n=None, sub=""):
        if n is None:
            return {"scale": a(f"{prefix}.weight"), "bias": a(f"{prefix}.bias")}
        return {"scale": stack(prefix, n, f"{sub}.weight"),
                "bias": stack(prefix, n, f"{sub}.bias")}

    def lin(prefix, n, sub, names):
        out = {}
        for mod, (w, b) in names.items():
            out[w] = stack(prefix, n, f"{sub}.{mod}.weight", transpose=True)
            if b is not None:
                out[b] = stack(prefix, n, f"{sub}.{mod}.bias")
        return out

    ne, nd = cfg.n_audio_layers, cfg.n_text_layers
    eb, db = "encoder.blocks", "decoder.blocks"
    enc = {c: {"w": a(f"encoder.{c}.weight").transpose(2, 1, 0), "b": a(f"encoder.{c}.bias")}
           for c in ("conv1", "conv2")}
    enc.update(pos_emb=a("encoder.pos_emb"), attn_ln=ln(eb, ne, "attn_ln"),
               attn=lin(eb, ne, "attn", _ATTN), mlp_ln=ln(eb, ne, "mlp_ln"),
               mlp=lin(eb, ne, "mlp", _MLP), ln_post=ln("encoder.ln_post"))
    dec = {"token_emb": a("decoder.token_emb"), "pos_emb": a("decoder.pos_emb"),
           "mlp_ln": ln(db, nd, "mlp_ln"), "mlp": lin(db, nd, "mlp", _MLP),
           "ln": ln("decoder.ln")}
    for name in ("self_attn", "cross_attn"):
        dec[f"{name}_ln"] = ln(db, nd, f"{name}_ln")
        dec[name] = lin(db, nd, name, _ATTN)
    tree = {"encoder": enc, "decoder": dec}
    if "proj_out" in sd:
        tree["proj_out"] = a("proj_out")
    return tree


def init_state_dict(cfg: WhisperConfig, seed: int = 0,
                    device=None) -> dict[str, torch.Tensor]:
    """Seeded random weights (f32) with the JAX package's init scheme:
    normal / sqrt(fan_in) for linear and conv weights, 0.02 for the token and
    text-position embeddings, zero biases, unit layer-norm scales, sinusoidal
    audio positions. Drawn on ``device`` (the CPU when None) by a generator
    there: a card's draws are other numbers than the CPU's for one seed, and
    save the copy of a large model's weights (large-v3: 6.2 GB)."""
    g = torch.Generator(device=device or "cpu").manual_seed(seed)
    dev = g.device
    with torch.device("meta"):
        shapes = {k: v.shape for k, v in Whisper(cfg).state_dict().items()}
    sd: dict[str, torch.Tensor] = {}
    for name, shape in shapes.items():
        if name == "encoder.pos_emb":
            sd[name] = torch.from_numpy(sinusoids(cfg.n_audio_ctx, cfg.d_model)).to(dev)
        elif name in ("decoder.token_emb", "decoder.pos_emb"):
            sd[name] = torch.randn(shape, generator=g, device=dev) * 0.02
        elif "_ln." in name or name.split(".")[1] in ("ln", "ln_post"):
            fill = 1.0 if name.endswith("weight") else 0.0
            sd[name] = torch.full(shape, fill, device=dev)
        elif name.endswith("bias"):
            sd[name] = torch.zeros(shape, device=dev)
        else:  # linear (out, in) or conv (O, I, W): JAX's fan_in is I
            sd[name] = torch.randn(shape, generator=g, device=dev) / math.sqrt(shape[1])
    return sd


def build_model(cfg: WhisperConfig, state_dict: dict | None = None, seed: int = 0,
                device="cuda", train: bool = False) -> Whisper:
    """A ``Whisper`` on ``device`` from a state dict (e.g. ``params_from_jax``)
    or the seeded init. Serving (``train=False``): block weights and
    embeddings stored in ``cfg``'s compute dtype, no gradients. Training:
    every parameter an f32 master that requires grad; the model casts it to
    the compute dtype at each use. A state dict with a ``proj_out`` gives
    the model an untied head; one with an int8 token embedding (from
    ``quantize_decoder_weights`` or a quantized JAX tree) gives int8 decoder
    weights, for decoding only."""
    device = resolve_device(device)
    if state_dict is None:
        state_dict = init_state_dict(cfg, seed)
    int8 = state_dict["decoder.token_emb"].dtype == torch.int8
    if int8 and train:
        raise ValueError("int8 decoder weights are decode-only; train from the float weights")
    with torch.device("meta"):
        model = Whisper(cfg, param_dtype=torch.float32 if train else None,
                        untied_head="proj_out" in state_dict)
        if int8:
            int8_decoder_layout(model)
    model = model.to_empty(device=device)
    model.load_state_dict(state_dict)
    return model.train().requires_grad_(True) if train else model.eval().requires_grad_(False)
