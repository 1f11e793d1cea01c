"""Whisper encoder/decoder in PyTorch.

The counterpart of the JAX package's ``models/whisper.py``, as
``nn.Module``s: the encoder and decoder hold their blocks in
``nn.ModuleList``s, linear weights are ``nn.Linear`` (out, in), convs
``nn.Conv1d`` (O, I, W). ``models/convert.py`` carries the JAX params tree
over. The numerics follow the JAX functions:

  * weights are cast to the compute dtype at each use, as in the JAX
    package: a training model (``build_model(..., train=True)``) holds f32
    masters, so its gradients are taken with respect to f32 weights; a
    serving model stores block weights and embeddings in the compute dtype,
    where the cast is a no-op. Layer norms and conv stems keep f32 weights,
    and every layer norm, softmax, conv stem and the vocab logits run in
    ``_acc``: f32, or float64 for a float64 model, as in the JAX package
  * a projection accumulates in f32, rounds to the compute dtype, then adds
    its bias in the compute dtype (``_proj``)
  * masks use the f32 minimum, not -inf, so fully masked rows (left-padded
    prefix slots) stay finite
  * with ``cfg.fused_ln_qkv`` / ``cfg.fused_ln_mlp`` the encoder and the
    full-sequence decoder run each pre-attention LayerNorm + QKV (and the
    cross-attention query), and each pre-MLP LayerNorm + first MLP product
    + gelu, through the fused LayerNorm+matmul kernel (``_ln_qkv``,
    ``_ln_proj``, ``_ln_mlp``), which adds the bias in f32 before its one
    rounding; the cached decoder keeps the unfused ops, as in JAX

The decoder has two modes: cached (prefill and single-token steps over a
preallocated KV cache, written in place) and full-sequence (training:
causal self-attention over the labels, the flash kernels at label lengths
of at least ``flash_decoder_min_seq``). In training, each block runs under
``cfg.remat`` (``_run_block``, ``_mlp_remat``): "full" recomputes the block
in the backward, "dots" saves only the outputs of products without batch
dims, "wide" saves everything but the 4*d-wide MLP tensors. The cached mode also
takes per-row cache offsets (speculative decoding, where rows advance at
different rates) and a per-query (B, S, T) mask (Medusa's chain trees).

``quantize_decoder_weights`` gives a decode-only copy of a model with int8
decoder weights: per-output-column scales for the attention and MLP
products (``Linear.weight`` int8 and a ``scale`` buffer), per-row scales for
the token embedding and an untied ``proj_out`` (``*_scale`` buffers). Their
products run as the JAX package's: the int8 values widened, an f32 product,
times the scale, rounded to the compute dtype.

A model from ``parallel.shard_params`` holds its rank's Megatron shard
(``model.tp``): column-parallel q, k, v and fc1 (``Linear.tp_col``),
row-parallel attention outputs and fc2 (``Linear.tp_row``, their partial
products summed over "model" in f32 before the one rounding and the
replicated bias), a vocab-parallel embedding and logits (gathered whole
before any logits processor). Head counts are local: a product's width over
``cfg.head_dim``. The code paths are the unsharded ones with the
collectives of ``parallel/tp.py`` at the places GSPMD puts them.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from .._device import acc_dtype as _acc
from ..ops.flash_attention import flash_attention
from ..ops.fused_block import fused_ln_matmul
from ..ops.quant_cross_attention import (
    quant_cross_attention_plain,
    quant_cross_attention_step_indexed,
)
from ..parallel.tp import (
    copy_to_model,
    gather_vocab,
    max_over_model,
    reduce_from_model,
    vocab_embedding,
)
from .config import WhisperConfig

def sinusoids(length: int, channels: int) -> np.ndarray:
    """Fixed sinusoidal position embeddings (public Whisper formula)."""
    assert channels % 2 == 0
    log_timescale_increment = np.log(10000) / (channels // 2 - 1)
    inv_timescales = np.exp(-log_timescale_increment * np.arange(channels // 2))
    scaled_time = np.arange(length)[:, None] * inv_timescales[None, :]
    return np.concatenate([np.sin(scaled_time), np.cos(scaled_time)], axis=1).astype(
        np.float32
    )


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------

def layer_norm(x: torch.Tensor, ln: nn.LayerNorm) -> torch.Tensor:
    """LayerNorm in f32 (float64 for a float64 x) regardless of compute dtype."""
    ft = _acc(x)
    return F.layer_norm(x.to(ft), ln.normalized_shape, ln.weight.to(ft), ln.bias.to(ft),
                        1e-5).to(x.dtype)


def _is_int8(lin: nn.Linear) -> bool:
    return lin.weight.dtype == torch.int8


def _proj(x: torch.Tensor, lin: nn.Linear) -> torch.Tensor:
    """x @ W^T + b with W and b cast to x's dtype: the product accumulates
    in f32 and rounds to x's dtype, then the bias adds in that dtype. An int8
    weight (``quantize_decoder_weights``) is widened, its f32 product scaled
    per output column, then rounded to x's dtype. A column-parallel product
    takes x through ``copy_to_model``; a row-parallel one sums its f32
    partial products over "model" before the rounding and the bias."""
    col, row = getattr(lin, "tp_col", None), getattr(lin, "tp_row", None)
    if col is not None:
        x = copy_to_model(x, col)
    if _is_int8(lin):
        y = F.linear(x.float(), lin.weight.float()) * lin.scale
        y = (y if row is None else reduce_from_model(y, row)).to(x.dtype)
    elif row is not None:
        ft = _acc(x)
        y = reduce_from_model(F.linear(x.to(ft), lin.weight.to(x.dtype).to(ft)), row).to(x.dtype)
    else:
        y = F.linear(x, lin.weight.to(x.dtype))
    if lin.bias is not None:
        y = y + lin.bias.to(x.dtype)
    return y


def _heads(x: torch.Tensor, cfg: WhisperConfig) -> int:
    """Heads in a merged-head tensor: all of them, or a tensor-parallel
    rank's share."""
    return x.shape[-1] // cfg.head_dim


def _fused_inputs(lin: nn.Linear, *xs):
    """The replicated inputs of a fused LayerNorm + column-parallel product
    (x, the LayerNorm's scale and bias) through ``copy_to_model``, so their
    gradients sum over "model"; as they are without tensor parallelism."""
    tp = getattr(lin, "tp_col", None)
    return xs if tp is None else tuple(copy_to_model(x, tp) for x in xs)


def _split_heads(x: torch.Tensor, n_heads: int) -> torch.Tensor:
    b, t, d = x.shape
    return x.reshape(b, t, n_heads, d // n_heads).transpose(1, 2)  # (B, H, T, dh)


def attention(q, k, v, n_heads: int, mask=None):
    """Plain multi-head attention over merged-head (B, T, D) tensors; ``mask``
    broadcasts to (B, H, Tq, Tk), True = attend."""
    dh = q.shape[-1] // n_heads
    ft = _acc(q)
    qh, kh, vh = (_split_heads(x, n_heads).to(ft) for x in (q, k, v))
    scores = (qh @ kh.transpose(-1, -2)) / math.sqrt(dh)
    if mask is not None:
        scores = torch.where(mask, scores, torch.finfo(ft).min)
    w = torch.softmax(scores, dim=-1).to(q.dtype)
    out = w.to(ft) @ vh
    b, _, tq, _ = out.shape
    return out.transpose(1, 2).reshape(b, tq, -1).to(q.dtype)


def _conv1d(x: torch.Tensor, conv: nn.Conv1d, stride: int) -> torch.Tensor:
    """x (B, C_in, T) -> (B, C_out, T/stride), padding 1. The product runs in
    f32 (float64 for a float64 x), then rounds to x's dtype before the bias."""
    ft = _acc(x)
    y = F.conv1d(x.to(ft), conv.weight.to(ft), None, stride=stride, padding=1)
    return y.to(x.dtype) + conv.bias.to(x.dtype)[:, None]


def _gelu(x, cfg: WhisperConfig):
    return F.gelu(x, approximate="tanh" if cfg.gelu_approx else "none")


def _ln_qkv(h, ln: nn.LayerNorm, attn: "Attention", cfg: WhisperConfig):
    """Pre-attention LayerNorm + QKV projections -> (q, k, v). With
    ``cfg.fused_ln_qkv`` one fused pass over h computes the three as one
    (N, 3d) product with W = [Wq | Wk | Wv] in the compute dtype and the
    bias [bq, 0, bv] (Whisper's key has no bias); q, k and v are views of
    its output."""
    if cfg.fused_ln_qkv and not _is_int8(attn.query):
        d = attn.query.weight.shape[0]  # a tensor-parallel rank's d / tp
        w = torch.cat([attn.query.weight, attn.key.weight, attn.value.weight]).to(h.dtype)
        b = torch.cat([attn.query.bias, attn.query.bias.new_zeros(d), attn.value.bias])
        qkv = fused_ln_matmul(*_fused_inputs(attn.query, h, ln.weight, ln.bias), w.t(), b)
        return qkv[..., :d], qkv[..., d:2 * d], qkv[..., 2 * d:]
    a = layer_norm(h, ln)
    return _proj(a, attn.query), _proj(a, attn.key), _proj(a, attn.value)


def _ln_proj(h, ln: nn.LayerNorm, lin: nn.Linear, cfg: WhisperConfig):
    """LayerNorm + one projection (the cross-attention query), fused under
    ``cfg.fused_ln_qkv``."""
    if cfg.fused_ln_qkv and not _is_int8(lin):
        return fused_ln_matmul(*_fused_inputs(lin, h, ln.weight, ln.bias),
                               lin.weight.to(h.dtype).t(), lin.bias)
    return _proj(layer_norm(h, ln), lin)


def _ln_mlp(h, ln: nn.LayerNorm, mlp: "MLP", cfg: WhisperConfig):
    """Pre-MLP LayerNorm + MLP. With ``cfg.fused_ln_mlp`` the LayerNorm, the
    first product, its bias and the gelu are one fused pass."""
    if cfg.fused_ln_mlp and not _is_int8(mlp.fc1):
        def fused(h):
            wide = fused_ln_matmul(*_fused_inputs(mlp.fc1, h, ln.weight, ln.bias),
                                   mlp.fc1.weight.to(h.dtype).t(), mlp.fc1.bias,
                                   act="gelu_tanh" if cfg.gelu_approx else "gelu")
            return _proj(wide, mlp.fc2)

        return _mlp_remat(fused, cfg, h)
    return _mlp_remat(functools.partial(mlp, cfg=cfg), cfg, layer_norm(h, ln))


def _mlp_remat(fn, cfg: WhisperConfig, x):
    """An MLP from its input through fc2: under ``remat="wide"``, while
    autograd records, a checkpoint whose recompute stops (early stop) once
    fc2's input exists, so only fc1 and the gelu rerun (the fused kernel at
    that site, under ``fused_ln_mlp``): the JAX package's
    ``save_anything_except_these_names("mlp_wide")``. A plain call
    otherwise."""
    if cfg.remat == "wide" and torch.is_grad_enabled():
        return checkpoint(fn, x, use_reentrant=False)
    return fn(x)


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------

class Attention(nn.Module):
    def __init__(self, d: int, dtype: torch.dtype):
        super().__init__()
        self.query = nn.Linear(d, d, dtype=dtype)
        self.key = nn.Linear(d, d, bias=False, dtype=dtype)  # no k bias in Whisper
        self.value = nn.Linear(d, d, dtype=dtype)
        self.out = nn.Linear(d, d, dtype=dtype)


class MLP(nn.Module):
    def __init__(self, d: int, dtype: torch.dtype):
        super().__init__()
        self.fc1 = nn.Linear(d, 4 * d, dtype=dtype)
        self.fc2 = nn.Linear(4 * d, d, dtype=dtype)

    def forward(self, x, cfg: WhisperConfig):
        return _proj(_gelu(_proj(x, self.fc1), cfg), self.fc2)


class EncoderBlock(nn.Module):
    def __init__(self, d: int, dtype: torch.dtype):
        super().__init__()
        self.attn_ln = nn.LayerNorm(d)
        self.attn = Attention(d, dtype)
        self.mlp_ln = nn.LayerNorm(d)
        self.mlp = MLP(d, dtype)

    def forward(self, h, cfg: WhisperConfig):
        q, k, v = _ln_qkv(h, self.attn_ln, self.attn, cfg)
        if cfg.flash_attention:
            att = flash_attention(q, k, v, _heads(q, cfg))
        else:
            att = attention(q, k, v, _heads(q, cfg))
        h = h + _proj(att, self.attn.out)
        return h + _ln_mlp(h, self.mlp_ln, self.mlp, cfg)


class AudioEncoder(nn.Module):
    def __init__(self, cfg: WhisperConfig, dt: torch.dtype):
        super().__init__()
        d = cfg.d_model
        self.conv1 = nn.Conv1d(cfg.n_mels, d, 3, padding=1)  # f32, as in JAX
        self.conv2 = nn.Conv1d(d, d, 3, stride=2, padding=1)
        # sinusoidal init; a parameter, as in the JAX params tree, so training
        # updates it as the JAX package does
        self.pos_emb = nn.Parameter(torch.from_numpy(sinusoids(cfg.n_audio_ctx, d)))
        self.blocks = nn.ModuleList(EncoderBlock(d, dt) for _ in range(cfg.n_audio_layers))
        self.ln_post = nn.LayerNorm(d)


class DecoderBlock(nn.Module):
    def __init__(self, d: int, dtype: torch.dtype):
        super().__init__()
        self.self_attn_ln = nn.LayerNorm(d)
        self.self_attn = Attention(d, dtype)
        self.cross_attn_ln = nn.LayerNorm(d)
        self.cross_attn = Attention(d, dtype)
        self.mlp_ln = nn.LayerNorm(d)
        self.mlp = MLP(d, dtype)


class TextDecoder(nn.Module):
    def __init__(self, cfg: WhisperConfig, dt: torch.dtype):
        super().__init__()
        d = cfg.d_model
        self.token_emb = nn.Parameter(torch.empty(cfg.n_vocab, d, dtype=dt))
        self.pos_emb = nn.Parameter(torch.empty(cfg.n_text_ctx, d, dtype=dt))
        self.blocks = nn.ModuleList(DecoderBlock(d, dt) for _ in range(cfg.n_text_layers))
        self.ln = nn.LayerNorm(d)
        self.n_vocab = cfg.n_vocab
        self.tp = None  # parallel.tp.TensorParallel of a vocab-parallel shard
        self._vocab_acc = None
        self._vocab_key = None

    def vocab_weight_acc(self, dtype: torch.dtype, head: torch.Tensor | None = None
                         ) -> torch.Tensor:
        """The vocab projection (``head``, an untied ``proj_out``, or else
        the tied token embedding), rounded to ``dtype`` and widened once to
        ``_acc`` (f32, or float64 for a float64 ``dtype``), so the logits come
        out of a product of the same values, in the same type, as the JAX
        package's. The cache is keyed on the weight it was made from.
        Detached: for inference only (``project_vocab`` keeps training in
        the graph)."""
        w = self.token_emb if head is None else head
        key = (w.data_ptr(), w._version, w.device, w.dtype, dtype)
        if self._vocab_key != key:
            wd = w.detach().to(dtype)
            self._vocab_acc = wd.to(_acc(wd))
            self._vocab_key = key
        return self._vocab_acc


class Whisper(nn.Module):
    """``param_dtype`` is the storage dtype of the block weights and the text
    embeddings: the compute dtype (serving, the default) or f32 (training).
    ``untied_head``: the model has its own vocab projection ``proj_out``
    (V, D), stored like the token embedding, in place of the tied one (the
    JAX params tree's optional ``proj_out``)."""

    def __init__(self, cfg: WhisperConfig, param_dtype: torch.dtype | None = None,
                 untied_head: bool = False):
        super().__init__()
        dt = param_dtype or cfg.compute_dtype
        self.cfg = cfg
        self.encoder = AudioEncoder(cfg, dt)
        self.decoder = TextDecoder(cfg, dt)
        self.proj_out = (nn.Parameter(torch.empty(cfg.n_vocab, cfg.d_model, dtype=dt))
                         if untied_head else None)
        self.tp = None  # parallel.tp.TensorParallel of a parallel.shard_params shard


def _dots_policy(ctx, op, *args, **kwargs):
    """``dots_with_no_batch_dims_saveable``: keep the outputs of products
    without batch dims (``mm``, ``addmm``, and the ``out_dtype`` overload of
    ``mm``); recompute the rest, batched attention products included. The
    kernels' ``ctypes`` launches are no aten ops, so they rerun, as a
    ``pallas_call`` (no dot) reruns in JAX."""
    if op.overloadpacket in (torch.ops.aten.mm, torch.ops.aten.addmm):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _run_block(fn, cfg: WhisperConfig, *args):
    """One transformer block under ``cfg.remat`` while autograd records (the
    JAX package's ``_remat``): "full" recomputes it in the backward, "dots"
    recomputes all but ``_dots_policy``'s saved products (selective
    checkpointing); "none" and "wide" (whose checkpoint sits in the MLP,
    ``_mlp_remat``) call it plainly."""
    if cfg.remat in ("none", "wide") or not torch.is_grad_enabled():
        return fn(*args)
    if cfg.remat == "dots":
        return checkpoint(fn, *args, use_reentrant=False, context_fn=functools.partial(
            create_selective_checkpoint_contexts, _dots_policy))
    return checkpoint(fn, *args, use_reentrant=False)


# ---------------------------------------------------------------------------
# encoder
# ---------------------------------------------------------------------------

def encode_audio(model: Whisper, mel: torch.Tensor) -> torch.Tensor:
    """mel: (B, n_mels, 2*n_audio_ctx) -> encoder states (B, n_audio_ctx, D)."""
    cfg, enc = model.cfg, model.encoder
    x = mel.to(cfg.compute_dtype)
    x = _gelu(_conv1d(x, enc.conv1, 1), cfg)
    x = _gelu(_conv1d(x, enc.conv2, 2), cfg)
    x = x.transpose(1, 2)  # (B, T, D)
    x = x + enc.pos_emb[: x.shape[1]].to(x.dtype)
    for blk in enc.blocks:
        x = _run_block(functools.partial(blk, cfg=cfg), cfg, x)
    return layer_norm(x, enc.ln_post)


# ---------------------------------------------------------------------------
# decoder
# ---------------------------------------------------------------------------

def precompute_cross_kv(model: Whisper, enc_out: torch.Tensor, out=None):
    """Cross-attention K/V for all layers: each (L, B, T_audio, D), written
    into ``out`` (a (k, v) pair of that shape) when given."""
    blocks = model.decoder.blocks
    ok, ov = (None, None) if out is None else out
    k = torch.stack([_proj(enc_out, b.cross_attn.key) for b in blocks], out=ok)
    v = torch.stack([_proj(enc_out, b.cross_attn.value) for b in blocks], out=ov)
    return k, v


def quantize_cross_kv(cross_kv, pad_to: int = 128, tp=None, out: dict | None = None) -> dict:
    """Per-position int8 quantization of the cross-attention K/V.

    scale = max|x| / 127 (at least 1e-8) per (layer, row, position), values
    rounded half to even; scales stored (L, B, 1, T). T is padded to a
    multiple of ``pad_to`` with ZERO scales: a zero k-scale marks a padded
    position, and both attention paths mask on it. Under tensor parallelism
    (``tp``, the model's) each rank holds D / tp of every position, so the
    max is taken over "model" too: the scales, and so the int8 values, are
    the unsharded ones. ``out``: a dict of these four tensors to write
    into, in place of new ones."""
    k, v = cross_kv
    t = k.shape[2]
    t_pad = ((t + pad_to - 1) // pad_to) * pad_to if pad_to else t

    def q(x, xq_pad, s_pad):
        # a layer at a time, so the f32 temporaries are one layer's; the max
        # is exact in x's dtype, and widening after it gives the max of the
        # widened values
        amax = torch.stack([xl.abs().amax(dim=-1, keepdim=True) for xl in x]).float()
        scale = (amax if tp is None else max_over_model(amax, tp)) / 127.0
        scale = torch.clamp(scale, min=1e-8)
        l, b, _, d = x.shape
        if xq_pad is None:
            xq_pad = torch.zeros((l, b, t_pad, d), dtype=torch.int8, device=x.device)
            s_pad = torch.zeros((l, b, 1, t_pad), dtype=torch.float32, device=x.device)
        else:
            xq_pad[:, :, t:] = 0
            s_pad[..., t:] = 0.0
        for i, xl in enumerate(x):
            xq_pad[i, :, :t] = torch.round(xl.float() / scale[i]).to(torch.int8)
        s_pad[:, :, 0, :t] = scale[..., 0]
        return xq_pad, s_pad

    out = out or {}
    k_q, k_s = q(k, out.get("k_q"), out.get("k_s"))
    v_q, v_s = q(v, out.get("v_q"), out.get("v_s"))
    return {"k_q": k_q, "k_s": k_s, "v_q": v_q, "v_s": v_s}


def _attention_quant_cross(q, kv, n_heads: int):
    """Cross attention against one layer's int8 K/V: q (B, S, D); kv k_q/v_q
    (B, T_pad, D) int8, k_s/v_s (B, 1, T_pad) f32, zero scale on padding."""
    return quant_cross_attention_plain(q, kv["k_q"], kv["k_s"], kv["v_q"], kv["v_s"],
                                       n_heads)


def _int8_linears(model: Whisper):
    """The decoder products ``quantize_decoder_weights`` makes int8: every
    block's self- and cross-attention q/k/v/o and both MLP products, with
    their state-dict prefixes."""
    for i, blk in enumerate(model.decoder.blocks):
        for grp in ("self_attn", "cross_attn"):
            for name in ("query", "key", "value", "out"):
                yield f"decoder.blocks.{i}.{grp}.{name}", getattr(getattr(blk, grp), name)
        for name in ("fc1", "fc2"):
            yield f"decoder.blocks.{i}.mlp.{name}", getattr(blk.mlp, name)


def int8_decoder_layout(model: Whisper) -> None:
    """Give ``model`` (in place, values unset) the layout of int8 decoder
    weights: each product of ``_int8_linears`` an int8 ``weight`` (out, in)
    and an f32 ``scale`` buffer (out,), the token embedding (and an untied
    ``proj_out``) int8 (V, D) with an f32 ``*_scale`` buffer (V, 1)."""
    def int8_param(p: torch.Tensor) -> nn.Parameter:
        return nn.Parameter(torch.empty(p.shape, dtype=torch.int8, device=p.device),
                            requires_grad=False)

    for _, lin in _int8_linears(model):
        lin.weight = int8_param(lin.weight)
        lin.register_buffer("scale", torch.empty(lin.weight.shape[0], device=lin.weight.device))
    dec = model.decoder
    dec.token_emb = int8_param(dec.token_emb)
    dec.register_buffer("token_emb_scale", torch.empty(dec.token_emb.shape[0], 1,
                                                        device=dec.token_emb.device))
    if model.proj_out is not None:
        model.proj_out = int8_param(model.proj_out)
        model.register_buffer("proj_out_scale", torch.empty(model.proj_out.shape[0], 1,
                                                            device=model.proj_out.device))


def _quantize(w: torch.Tensor, dim: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 with one f32 scale per slice along ``dim``: scale =
    max|w| / 127 (at least 1e-8), values rounded half to even."""
    wf = w.float()
    s = torch.clamp(wf.abs().amax(dim=dim, keepdim=True) / 127.0, min=1e-8)
    return torch.round(wf / s).to(torch.int8), s


@torch.no_grad()
def quantize_decoder_weights(model: Whisper) -> Whisper:
    """Weight-only int8 for the decoder, decode only (not differentiable): a
    new serving model on ``model``'s device whose decoder products have
    per-output-column scales and whose token embedding (and untied
    ``proj_out``) have per-row scales. The encoder, layer norms, biases and
    position tables keep their weights. The JAX package quantizes its f32
    params; this quantizes the weights ``model`` holds (the compute dtype in
    a serving model)."""
    from .convert import build_model

    sd = dict(model.state_dict())
    for prefix, _ in _int8_linears(model):
        q, s = _quantize(sd[f"{prefix}.weight"], dim=1)  # (out, in): per output column
        sd[f"{prefix}.weight"], sd[f"{prefix}.scale"] = q, s[:, 0]
    for name in ("decoder.token_emb", "proj_out"):
        if name in sd:
            sd[name], sd[f"{name}_scale"] = _quantize(sd[name], dim=1)  # (V, D): per row
    return build_model(model.cfg, sd, device=next(model.parameters()).device)


def kv_width(model: Whisper) -> int:
    """Width of the decoder's K/V: d_model, or a tensor-parallel rank's
    d_model / tp."""
    return model.decoder.blocks[0].self_attn.key.weight.shape[0]


def init_kv_cache(cfg: WhisperConfig, batch: int, max_len: int, device,
                  width: int | None = None) -> dict:
    """Zeroed self-attention caches (L, B, max_len, width) in the compute
    dtype; ``width`` (``kv_width``) defaults to d_model."""
    shape = (cfg.n_text_layers, batch, max_len, width or cfg.d_model)
    dt = cfg.compute_dtype
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}


def _decoder_block_full(blk: DecoderBlock, h, ck, cv, cfg: WhisperConfig, use_flash: bool,
                        causal_mask):
    """One decoder block in full-sequence mode: causal self-attention over
    the whole sequence, cross-attention over one layer's (B, T, D) K/V."""
    q, k, v = _ln_qkv(h, blk.self_attn_ln, blk.self_attn, cfg)
    nh = _heads(q, cfg)
    if use_flash:
        att = flash_attention(q, k, v, nh, causal=True)
    else:
        att = attention(q, k, v, nh, causal_mask)
    h = h + _proj(att, blk.self_attn.out)
    cq = _ln_proj(h, blk.cross_attn_ln, blk.cross_attn.query, cfg)
    if use_flash:
        catt = flash_attention(cq, ck, cv, nh)
    else:
        catt = attention(cq, ck, cv, nh)
    h = h + _proj(catt, blk.cross_attn.out)
    return h + _ln_mlp(h, blk.mlp_ln, blk.mlp, cfg)


def embed_tokens(dec: TextDecoder, tokens: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """Token embeddings in ``dt``; an int8 table (``quantize_decoder_weights``)
    is widened and scaled per row in f32 first. A vocab-parallel table looks
    up its own ids and sums over "model"."""
    if dec.token_emb.dtype == torch.int8:
        def rows(i):
            return (dec.token_emb[i].float() * dec.token_emb_scale[i]).to(dt)
    else:
        def rows(i):
            return dec.token_emb[i].to(dt)
    if dec.tp is not None:
        return vocab_embedding(dec.token_emb, tokens, dec.tp, dec.n_vocab, rows)
    return rows(tokens)


def _write_cache(c: torch.Tensor, new: torch.Tensor, pos_offset) -> None:
    """Write ``new`` (B, S, D) into one layer's cache (B, T, D) in place at
    slot ``pos_offset``: an int, a 0-dim device tensor (one slot for every
    row, never read by the host), or, per row, ``pos_offset[b]`` ((B,)). A
    per-row start that would run past the cache is clamped to T - S, as
    ``lax.dynamic_update_slice`` clamps it in the JAX package (whose callers
    size their caches so that it never happens)."""
    if isinstance(pos_offset, int):
        c[:, pos_offset:pos_offset + new.shape[1]] = new
        return
    b, s = new.shape[:2]
    steps = torch.arange(s, device=c.device)
    if pos_offset.ndim == 0:
        c.index_copy_(1, pos_offset + steps, new.to(c.dtype))
        return
    start = torch.clamp(pos_offset, 0, c.shape[1] - s)
    c[torch.arange(b, device=c.device)[:, None], start[:, None] + steps] = new.to(c.dtype)


def decode_tokens(
    model: Whisper,
    tokens: torch.Tensor,              # (B, S) int
    cross_kv=None,                     # (k, v) each (L, B, T, D), or the int8 dict
    cache: dict | None = None,         # KV cache from init_kv_cache, written in place
    pos_offset: int | torch.Tensor = 0,  # cache slot of tokens[:, 0]: an int, a
                                         # 0-dim tensor (a device slot: the
                                         # captured greedy step), or (B,) per
                                         # row (speculative decoding: rows
                                         # advance at different rates)
    token_positions: torch.Tensor | None = None,  # (B, S) position ids (left-pad)
    self_mask: torch.Tensor | None = None,        # True=attend: (B, T_cache) key-side,
                                                  # or (B, S, T_cache) per query (trees)
    enc_out: torch.Tensor | None = None,          # (B, T, D), when cross_kv is None
    return_hidden: bool = False,       # also return the final-LN states (B, S, D)
):
    """Decoder forward. Cached mode: keys/values of ``tokens`` are written
    into ``cache`` at slots ``pos_offset..pos_offset+S`` (in place; per row
    for a (B,) offset) and attention spans the whole cache with later slots
    masked; a 0-dim tensor offset stays on the device (no host read), so
    the step can be captured in a CUDA graph. Full-sequence mode
    (``cache=None``, training): causal self-attention over ``tokens``. Returns (f32 logits (B, S, V), cache or
    None), and the final-LN decoder states after them with
    ``return_hidden`` (the Medusa heads' input)."""
    if cross_kv is None:
        if enc_out is None:
            raise ValueError("need enc_out or cross_kv")
        cross_kv = precompute_cross_kv(model, enc_out)
    cfg, dec = model.cfg, model.decoder
    dt = cfg.compute_dtype
    b, s = tokens.shape
    dev = tokens.device
    per_row = isinstance(pos_offset, torch.Tensor) and pos_offset.ndim == 1
    if isinstance(pos_offset, torch.Tensor):
        pos_offset = pos_offset.to(device=dev, dtype=torch.int64)
    else:
        pos_offset = int(pos_offset)

    if token_positions is None:
        token_positions = (pos_offset[:, None] if per_row else pos_offset) + torch.arange(
            s, device=dev)[None, :]
    x = embed_tokens(dec, tokens, dt) + dec.pos_emb[token_positions].to(dt)
    quantized = isinstance(cross_kv, dict)

    if cache is None:
        if quantized:
            raise ValueError("quantized cross-KV is decode-only (cached mode)")
        use_flash = cfg.flash_attention and cfg.flash_decoder and s >= cfg.flash_decoder_min_seq
        causal = None if use_flash else torch.ones(s, s, dtype=torch.bool, device=dev).tril()
        for li, blk in enumerate(dec.blocks):
            fn = functools.partial(_decoder_block_full, blk, cfg=cfg, use_flash=use_flash,
                                   causal_mask=causal)
            x = _run_block(fn, cfg, x, cross_kv[0][li].to(dt), cross_kv[1][li].to(dt))
        x = layer_norm(x, dec.ln)
        return (project_vocab(model, x), None) + ((x,) if return_hidden else ())

    t_cache = cache["k"].shape[2]
    # causal over cache *slots* (slot i holds token i of the padded sequence;
    # position ids lag slots under left-padding, so compare slots)
    key_slot = torch.arange(t_cache, device=dev)
    if per_row:
        query_slot = pos_offset[:, None] + torch.arange(s, device=dev)[None, :]
        attn_mask = key_slot[None, None, :] <= query_slot[:, :, None]  # (B, S, T)
    else:
        query_slot = pos_offset + torch.arange(s, device=dev)
        attn_mask = key_slot[None, None, :] <= query_slot[None, :, None]  # (1, S, T)
    if self_mask is not None:
        # (B, T): key-side mask shared by every query (left padding); (B, S,
        # T): one mask a query (sibling chain slots of a Medusa tree hidden)
        attn_mask = attn_mask & (self_mask if self_mask.ndim == 3 else self_mask[:, None, :])
    attn_mask = attn_mask[:, None]  # (B|1, 1, S, T) -> broadcast over heads

    for li, blk in enumerate(dec.blocks):
        a = layer_norm(x, blk.self_attn_ln)
        q = _proj(a, blk.self_attn.query)
        ck, cv = cache["k"][li], cache["v"][li]
        _write_cache(ck, _proj(a, blk.self_attn.key), pos_offset)
        _write_cache(cv, _proj(a, blk.self_attn.value), pos_offset)
        nh = _heads(q, cfg)
        x = x + _proj(attention(q, ck, cv, nh, attn_mask), blk.self_attn.out)

        cq = _proj(layer_norm(x, blk.cross_attn_ln), blk.cross_attn.query)
        if quantized and s == 1 and cfg.fused_quant_cross:
            catt = quant_cross_attention_step_indexed(
                cq, cross_kv["k_q"], cross_kv["k_s"], cross_kv["v_q"], cross_kv["v_s"],
                li, nh)
        elif quantized:
            catt = _attention_quant_cross(
                cq, {name: t[li] for name, t in cross_kv.items()}, nh)
        else:
            catt = attention(cq, cross_kv[0][li], cross_kv[1][li], nh)
        x = x + _proj(catt, blk.cross_attn.out)
        x = x + blk.mlp(layer_norm(x, blk.mlp_ln), cfg)

    x = layer_norm(x, dec.ln)
    return (project_vocab(model, x), cache) + ((x,) if return_hidden else ())


def project_vocab(model: Whisper, x: torch.Tensor) -> torch.Tensor:
    """Vocab projection of decoder states (B, S, D) -> ``_acc`` logits
    (B, S, V), f32 (float64 for a float64 model): compute-dtype operands,
    the product and its output in ``_acc``. The projection is ``proj_out``
    when the model has an untied head, else the token embedding (tied); an
    int8 one is scaled per vocab row after the product. While autograd
    records a trainable weight, the cast stays in the graph, so the weight
    gets the projection's share of its gradient. A vocab-parallel shard
    computes its columns, gathered whole over "model"."""
    head = model.proj_out
    w = model.decoder.token_emb if head is None else head
    ft = _acc(x)
    tp = model.tp
    if tp is not None:
        x = copy_to_model(x, tp)
    if torch.is_grad_enabled() and w.requires_grad:
        logits = F.linear(x.to(ft), w.to(x.dtype).to(ft))
    else:
        logits = F.linear(x.to(ft), model.decoder.vocab_weight_acc(x.dtype, head))
        if w.dtype == torch.int8:
            scale = model.decoder.token_emb_scale if head is None else model.proj_out_scale
            logits = logits * scale[:, 0]
    return logits if tp is None else gather_vocab(logits, tp, model.cfg.n_vocab)


def forward(model: Whisper, input_features: torch.Tensor,
            decoder_input_ids: torch.Tensor) -> torch.Tensor:
    """Training forward: mel (B, n_mels, frames) + teacher-forced tokens
    (B, S) -> f32 logits (B, S, V) (the full-sequence decoder)."""
    enc_out = encode_audio(model, input_features)
    logits, _ = decode_tokens(model, decoder_input_ids, enc_out=enc_out)
    return logits


def forward_hidden(model: Whisper, input_features: torch.Tensor,
                   decoder_input_ids: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``forward`` that also returns the final-LN decoder states (B, S, D):
    the Medusa heads' training input."""
    enc_out = encode_audio(model, input_features)
    logits, _, hid = decode_tokens(model, decoder_input_ids, enc_out=enc_out,
                                   return_hidden=True)
    return logits, hid
