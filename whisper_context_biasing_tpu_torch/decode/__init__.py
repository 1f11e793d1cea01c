"""Decoding: batched greedy and beam decode with the in-loop bias-trie
processor, language identification, and sequential long-form transcription."""

from .bias_processor import (
    BiasTrieState,
    advance_bias_state,
    bias_bonus,
    bias_score_adjust,
    init_bias_state,
    sanitize_bias_spans,
    seed_bias_state_from_prefix,
)
from .greedy import (
    GreedyResult,
    apply_timestamp_rules,
    decode_batch,
    greedy_decode,
    pack_prefixes,
)
from .beam import BeamResult, beam_decode, beam_decode_batch
from .language import detect_language, resolve_start_tokens
from .long_form import (
    split_windows,
    transcribe_long,
    transcribe_long_batch,
    unpack_long_form,
)

__all__ = [
    "BiasTrieState",
    "advance_bias_state",
    "bias_bonus",
    "bias_score_adjust",
    "init_bias_state",
    "sanitize_bias_spans",
    "seed_bias_state_from_prefix",
    "GreedyResult",
    "apply_timestamp_rules",
    "decode_batch",
    "greedy_decode",
    "pack_prefixes",
    "BeamResult",
    "beam_decode",
    "beam_decode_batch",
    "detect_language",
    "resolve_start_tokens",
    "split_windows",
    "transcribe_long",
    "transcribe_long_batch",
    "unpack_long_form",
]
