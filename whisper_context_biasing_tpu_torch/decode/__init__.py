"""Decoding: batched greedy decode with the in-loop bias-trie processor."""

from .bias_processor import (
    BiasTrieState,
    advance_bias_state,
    bias_bonus,
    init_bias_state,
    sanitize_bias_spans,
    seed_bias_state_from_prefix,
)
from .greedy import GreedyResult, decode_batch, greedy_decode, pack_prefixes

__all__ = [
    "BiasTrieState",
    "advance_bias_state",
    "bias_bonus",
    "init_bias_state",
    "sanitize_bias_spans",
    "seed_bias_state_from_prefix",
    "GreedyResult",
    "decode_batch",
    "greedy_decode",
    "pack_prefixes",
]
