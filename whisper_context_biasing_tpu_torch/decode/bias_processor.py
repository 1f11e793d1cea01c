"""Vectorized bias-word logits processor (shallow fusion over token spans).

The counterpart of the JAX package's ``decode/bias_processor.py``: the
bias-word list is advanced as a dense integer trie on the device, so each
decode step adds a bonus to the tokens that extend any bias span with no
host round trip.

State: ``(B, N)`` int32 — how many tokens of span ``n`` the current
hypothesis suffix has matched. Spans are the collator's dense ``(B, N, K)``
int32 padded with 50256.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..data.collator import BIAS_SPAN_PAD_ID


class BiasTrieState(NamedTuple):
    matched: torch.Tensor   # (B, N) int32: matched prefix length per span
    span_len: torch.Tensor  # (B, N) int32: true span lengths (0 = empty/pad row)


def sanitize_bias_spans(spans):
    """Treat the collator's all-empty fallback — zeros of shape (B, 1, 1) —
    as "no spans", so decode-time biasing never reads it as a real length-1
    span of token id 0."""
    if spans is None:
        return None
    arr = spans.cpu().numpy() if isinstance(spans, torch.Tensor) else np.asarray(spans)
    if arr.shape[1:] == (1, 1) and not arr.any():
        return None
    return spans


def init_bias_state(bias_spans: torch.Tensor, pad_id: int = BIAS_SPAN_PAD_ID) -> BiasTrieState:
    """bias_spans: (B, N, K) int32, padded with ``pad_id``."""
    span_len = (bias_spans != pad_id).sum(dim=-1).to(torch.int32)
    matched = torch.zeros(bias_spans.shape[:2], dtype=torch.int32, device=bias_spans.device)
    return BiasTrieState(matched, span_len)


def _at(spans: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """spans[b, n, idx[b, n]] -> (B, N)."""
    return torch.gather(spans, -1, idx.long()[..., None])[..., 0]


def bias_bonus(state: BiasTrieState, bias_spans: torch.Tensor, vocab_size: int,
               boost: float) -> torch.Tensor:
    """Per-step additive logit bonus (B, V) f32: each span whose next
    expected token is t contributes ``boost`` to t (a scatter-max over spans,
    so duplicated words don't double-count)."""
    b, n, k = bias_spans.shape
    next_tok = _at(bias_spans, torch.clamp(state.matched, max=k - 1))
    active = state.matched < state.span_len  # span not yet fully matched
    safe_tok = torch.where(active, next_tok, 0).long()
    vals = torch.where(active, float(boost), 0.0).to(torch.float32)
    bonus = torch.zeros((b, vocab_size), dtype=torch.float32, device=bias_spans.device)
    return bonus.scatter_reduce_(1, safe_tok, vals, reduce="amax")


def bias_score_adjust(state: BiasTrieState, bias_spans: torch.Tensor, vocab_size: int,
                      boost: float) -> torch.Tensor:
    """Score-exact shallow fusion for beam search (B, V) f32: a beam's
    accumulated bias bonus is ``boost * len(span)`` for every completed span
    and exactly 0 for partial matches that later fail.

    adjust[v] = boost * sum_n new_matched_n(v) - boost * sum_n matched_n,
    where new_matched_n(v) is what ``advance_bias_state`` gives on emitting
    v: matched_n + 1 if v extends span n, 1 if v (re)starts it, else 0.
    (Greedy decoding keeps the prospective ``bias_bonus``: emitted tokens
    cannot be retracted.)"""
    b, n, k = bias_spans.shape
    next_tok = _at(bias_spans, torch.clamp(state.matched, max=k - 1))
    first = bias_spans[..., 0]
    active = (state.matched < state.span_len) & (state.span_len > 0)
    pending = state.matched.sum(dim=-1).to(torch.float32) * boost  # (B,)
    relief_vals = torch.where(active, (state.matched + 1).to(torch.float32) * boost, 0.0)
    relief = torch.zeros((b, vocab_size), dtype=torch.float32, device=bias_spans.device)
    relief.scatter_add_(1, torch.where(active, next_tok, 0).long(), relief_vals)
    # restart credit: v == first[n] that does not extend span n re-enters it
    # at matched=1; gated off when first IS the extension token
    restart = (state.span_len > 0) & ~(active & (next_tok == first))
    relief.scatter_add_(1, torch.where(restart, first, 0).long(),
                        torch.where(restart, float(boost), 0.0).to(torch.float32))
    return relief - pending[:, None]


def seed_bias_state_from_prefix(
    state: BiasTrieState,
    bias_spans: torch.Tensor,   # (B, N, K)
    prefix_ids: torch.Tensor,   # (B, P) left-padded conditioning prefix
    prefix_mask: torch.Tensor | None = None,  # (B, P) False = pad
) -> BiasTrieState:
    """Warm-start the trie from the conditioning context's tail: fold the
    last ``K`` (= max span length) real prefix tokens through
    ``advance_bias_state``, skipping pad positions, so a context that ends
    mid-bias-word gets the completion bonus from step 1."""
    p = prefix_ids.shape[1]
    w = min(bias_spans.shape[-1], p)
    for j in range(p - w, p):
        new = advance_bias_state(state, bias_spans, prefix_ids[:, j])
        if prefix_mask is not None:
            new = BiasTrieState(
                torch.where(prefix_mask[:, j, None], new.matched, state.matched),
                state.span_len)
        state = new
    return state


def advance_bias_state(state: BiasTrieState, bias_spans: torch.Tensor,
                       token: torch.Tensor) -> BiasTrieState:
    """Advance each span's matched length: extend on match, else restart
    (matched=1 if the token re-starts the span, 0 otherwise). Completed spans
    also restart so repeated mentions keep getting biased."""
    b, n, k = bias_spans.shape
    expected = _at(bias_spans, torch.clamp(state.matched, max=k - 1))
    first = bias_spans[..., 0]
    tok = token[:, None]
    in_progress = state.matched < state.span_len
    extended = torch.where(in_progress & (expected == tok), state.matched + 1, 0)
    restarted = torch.where((first == tok) & (state.span_len > 0), 1, 0)
    new_matched = torch.maximum(extended, restarted).to(torch.int32)
    # a just-completed span resets (ready to match the next mention)
    new_matched = torch.where(new_matched >= state.span_len, 0, new_matched)
    return BiasTrieState(new_matched.to(torch.int32), state.span_len)
