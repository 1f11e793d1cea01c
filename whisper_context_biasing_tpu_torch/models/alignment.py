"""Cross-attention alignment matrices for word-level timestamps.

The counterpart of the JAX package's ``models/alignment.py``: a
teacher-forced decoder pass whose cross-attention weights, restricted to a
set of alignment heads, are standardised per frame column over the valid
token rows, median-filtered over frames and summed over the selected heads
of every layer, then DTW-aligned (``decode/word_timestamps.py``) to map each
decoded token to an audio frame.

It is plain torch, not a kernel: the pass needs the attention weights
themselves (which no kernel returns) and runs once per aligned batch, as in
the JAX package, which computes it outside any Pallas call. The pass walks
the decoder's ``nn.ModuleList`` blocks with explicit causal self-attention
and f32 softmax cross-attention weights, and the same gelu variant as the
serving pass, so it is a pass of the network that decoded.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .._device import acc_dtype as _acc
from ..parallel.tp import reduce_from_model
from .config import _FAMILY, WhisperConfig
from .whisper import (
    Whisper,
    _proj,
    _split_heads,
    attention,
    embed_tokens,
    layer_norm,
    precompute_cross_kv,
    project_vocab,
)

# Published per-model alignment-head sets: the (decoder layer, head) pairs
# whose cross-attention is the most diagonal, shipped with the public Whisper
# distributions (openai-whisper ``_ALIGNMENT_HEADS``, ``alignment_heads`` of the
# HF hub models' generation_config.json). Other geometries fall back to
# :func:`default_alignment_mask`.
ALIGNMENT_HEADS: dict[str, tuple[tuple[int, int], ...]] = {
    "tiny.en": ((1, 0), (2, 0), (2, 5), (3, 0), (3, 1), (3, 2), (3, 3), (3, 4)),
    "tiny": ((2, 2), (3, 0), (3, 2), (3, 3), (3, 4), (3, 5)),
    "base.en": ((3, 3), (4, 7), (5, 1), (5, 5), (5, 7)),
    "base": ((3, 1), (4, 2), (4, 3), (4, 7), (5, 1), (5, 2), (5, 4), (5, 6)),
    "small.en": ((6, 6), (7, 0), (7, 3), (7, 8), (8, 2), (8, 5), (8, 7), (9, 0), (9, 4),
                 (9, 8), (9, 10), (10, 0), (10, 1), (10, 2), (10, 3), (10, 6), (10, 11),
                 (11, 2), (11, 4)),
    "small": ((5, 3), (5, 9), (8, 0), (8, 4), (8, 7), (8, 8), (9, 0), (9, 7), (9, 9), (10, 5)),
    "medium.en": ((11, 4), (14, 1), (14, 12), (14, 14), (15, 4), (16, 0), (16, 4), (16, 9),
                  (17, 12), (17, 14), (18, 7), (18, 10), (18, 15), (20, 0), (20, 3), (20, 9),
                  (20, 14), (21, 12)),
    "medium": ((13, 15), (15, 4), (15, 15), (16, 1), (20, 0), (23, 4)),
    "large": ((9, 19), (11, 2), (11, 4), (11, 17), (22, 7), (22, 11), (22, 17), (23, 2),
              (23, 15)),  # large-v1
    "large-v2": ((10, 12), (13, 17), (16, 11), (16, 12), (16, 13), (17, 15), (17, 16),
                 (18, 4), (18, 11), (18, 19), (19, 11), (21, 2), (21, 3), (22, 3), (22, 9),
                 (22, 12), (23, 5), (23, 7), (23, 13), (25, 5), (26, 1), (26, 12), (27, 15)),
    "large-v3": ((7, 0), (10, 17), (12, 18), (13, 12), (16, 1), (17, 14), (19, 11), (21, 4),
                 (24, 1), (25, 6)),
    "large-v3-turbo": ((2, 4), (2, 11), (3, 3), (3, 6), (3, 11), (3, 14)),
}


def lookup_alignment_heads(model_name: str | None, cfg: WhisperConfig | None = None
                           ) -> tuple[tuple[int, int], ...] | None:
    """The published head set for ``model_name``, or None when unknown. With
    ``cfg`` the set must fit its decoder (a fine-tune that changed depth or
    heads falls back to the heuristic instead of indexing out of range)."""
    if not model_name:
        return None
    heads = ALIGNMENT_HEADS.get(model_name.strip())
    if heads is None or cfg is None:
        return heads
    if all(layer < cfg.n_text_layers and h < cfg.n_heads for layer, h in heads):
        return heads
    return None


def infer_model_name(cfg: WhisperConfig) -> str | None:
    """The stock model name of a config's geometry (d_model, heads, layer
    counts, mels, vocab), or None. The 80-mel 32-layer geometry of
    large(-v1) and large-v2 resolves to large-v2."""
    for base, (d, h, al, tl) in _FAMILY.items():
        if base.startswith("distil-"):
            continue  # no published alignment heads for the distil family
        if (cfg.d_model, cfg.n_heads, cfg.n_audio_layers, cfg.n_text_layers) != (d, h, al, tl):
            continue
        mels = 128 if base.startswith("large-v3") else 80
        if cfg.n_mels != mels:
            continue
        if not cfg.multilingual:
            if base.startswith("large"):
                continue  # no English-only large variants
            return f"{base}.en"
        if base in ("large", "large-v2"):
            return "large-v2"
        return base
    return None


def heads_to_mask(cfg: WhisperConfig, heads) -> torch.Tensor:
    """[(layer, head), ...] -> (L, H) f32 mask. Pairs outside the decoder are
    dropped (a negative index counts from the end), as JAX's ``.at[].set``
    does."""
    mask = torch.zeros((cfg.n_text_layers, cfg.n_heads), dtype=torch.float32)
    for layer, h in heads:
        if -cfg.n_text_layers <= layer < cfg.n_text_layers and -cfg.n_heads <= h < cfg.n_heads:
            mask[layer, h] = 1.0
    return mask


def default_alignment_mask(cfg: WhisperConfig) -> torch.Tensor:
    """(L, H) f32 mask selecting every head of the top half of the decoder
    layers, whose cross-attention is the most diagonal: the fallback for a
    geometry that matches no stock model."""
    n = cfg.n_text_layers
    mask = torch.zeros((n, cfg.n_heads), dtype=torch.float32)
    mask[n - n // 2:] = 1.0
    return mask


def resolve_alignment_mask(cfg: WhisperConfig, heads: list[tuple[int, int]] | None = None,
                           model_name: str | None = None) -> torch.Tensor:
    """(L, H) alignment-head mask: explicit ``heads``, else the published set
    for ``model_name``, else the published set of the config's stock
    geometry, else the top-half heuristic."""
    if heads is not None:
        return heads_to_mask(cfg, heads)
    published = (lookup_alignment_heads(model_name, cfg)
                 or lookup_alignment_heads(infer_model_name(cfg), cfg))
    if published is not None:
        return heads_to_mask(cfg, published)
    return default_alignment_mask(cfg)


def median_filter_time(w: torch.Tensor, width: int) -> torch.Tensor:
    """Median filter along the last (frame) axis, reflect-padded: the middle
    of a sort over ``width`` shifted copies (the JAX package's
    ``median_filter_time``; numpy's reflect rule, so a pad wider than the
    axis reflects again)."""
    if width <= 1:
        return w
    pad = width // 2
    n = w.shape[-1]
    idx = torch.from_numpy(np.pad(np.arange(n), pad, mode="reflect")).to(w.device)
    wp = w[..., idx]
    stack = torch.stack([wp[..., i:i + n] for i in range(width)], dim=-1)
    return torch.sort(stack, dim=-1).values[..., pad]


@torch.no_grad()
def alignment_matrix(
    model: Whisper,
    tokens: torch.Tensor,        # (B, S) int: whole sequences with prefix and eot
    enc_out: torch.Tensor,       # (B, T_audio, D)
    head_mask: torch.Tensor,     # (L, H) f32: the alignment heads
    token_mask: torch.Tensor,    # (B, S) f32: 1 for real tokens, 0 for padding
    *,
    num_frames: int,             # content frames (<= T_audio)
    medfilt_width: int = 7,
    with_probs: bool = False,
):
    """Teacher-forced decoder pass -> the (B, S, num_frames) f32
    token-to-frame alignment matrix: per alignment head the attention
    distribution over frames, standardised per frame column over the valid
    token rows (padding rows left out, so a clip's matrix is the same however
    the batch is padded), median-filtered over frames, summed over the
    selected heads of every layer and divided by their count.

    ``with_probs=True`` also returns (B, S) f32 ``P(tokens[t] | tokens[<t],
    audio)`` from the same pass (position 0 has no context and is 1.0),
    projecting the vocab 16 positions at a time."""
    cfg, dec = model.cfg, model.decoder
    dt = cfg.compute_dtype
    dev = enc_out.device
    tokens = tokens.to(device=dev, dtype=torch.int64)
    b, s = tokens.shape
    # a tensor-parallel rank holds heads [h0, h0 + nh); its sum over them is
    # summed over "model" at the end
    dh = cfg.head_dim
    nh = dec.blocks[0].cross_attn.query.weight.shape[0] // dh
    h0 = 0 if model.tp is None else model.tp.rank * nh
    head_mask = head_mask.to(device=dev, dtype=torch.float32)
    local_mask = head_mask[:, h0:h0 + nh]

    x = embed_tokens(dec, tokens, dt) + dec.pos_emb[torch.arange(s, device=dev)][None].to(dt)
    cross_k, cross_v = precompute_cross_kv(model, enc_out)
    causal = torch.ones(s, s, dtype=torch.bool, device=dev).tril()
    tmask = token_mask.to(device=dev, dtype=torch.float32)
    n_valid = torch.clamp(tmask.sum(dim=1), min=1.0)[:, None, None, None]
    tm = tmask[:, None, :, None]

    contribs = []
    for li, blk in enumerate(dec.blocks):
        a = layer_norm(x, blk.self_attn_ln)
        q, k, v = (_proj(a, blk.self_attn.query), _proj(a, blk.self_attn.key),
                   _proj(a, blk.self_attn.value))
        x = x + _proj(attention(q, k, v, nh, causal), blk.self_attn.out)

        cq = _proj(layer_norm(x, blk.cross_attn_ln), blk.cross_attn.query)
        ft = _acc(cq)
        qh = _split_heads(cq, nh).to(ft)
        kh = _split_heads(cross_k[li].to(dt), nh).to(ft)
        vh = _split_heads(cross_v[li].to(dt), nh)
        sc = (qh @ kh.transpose(-1, -2)).to(torch.float32) / math.sqrt(dh)
        w = torch.softmax(sc, dim=-1)                                  # (B, H, S, T) f32
        ca = (w.to(dt).to(ft) @ vh.to(ft)).to(dt)
        x = x + _proj(ca.transpose(1, 2).reshape(b, s, -1), blk.cross_attn.out)
        x = x + blk.mlp(layer_norm(x, blk.mlp_ln), cfg)

        # standardise each (head, frame) column over the valid token rows,
        # median-filter over frames, sum over the selected heads
        ww = w[..., :num_frames]
        mean = (ww * tm).sum(dim=-2, keepdim=True) / n_valid
        var = ((ww - mean).square() * tm).sum(dim=-2, keepdim=True) / n_valid
        wn = (ww - mean) * torch.rsqrt(var + 1e-8)
        wn = median_filter_time(wn, medfilt_width)
        contribs.append(torch.einsum("bhsf,h->bsf", wn, local_mask[li]))

    total = torch.stack(contribs).sum(dim=0)
    if model.tp is not None:
        total = reduce_from_model(total, model.tp)
    matrix = total / torch.clamp(head_mask.sum(), min=1.0)
    if not with_probs:
        return matrix
    # P(tokens[t + 1] | tokens[<= t]) from the final states, 16 positions at
    # a time, so the (B, S, V) logits never exist whole
    hs = layer_norm(x, dec.ln)
    nxt = torch.ones((b, s), dtype=torch.float32, device=dev)
    for lo in range(0, s - 1, 16):
        hi = min(lo + 16, s - 1)
        lg = project_vocab(model, hs[:, lo:hi]).to(torch.float32)    # (B, <=16, V)
        lse = torch.logsumexp(lg, dim=-1)
        chosen = lg.gather(-1, tokens[:, lo + 1:hi + 1, None])[..., 0]
        nxt[:, lo + 1:hi + 1] = torch.exp(chosen - lse)
    return matrix, nxt
