"""Decoding: batched greedy and beam decode with the in-loop bias-trie
processor, speculative (draft model) and Medusa (self-speculative) greedy
decode, language identification, sequential and chunked long-form
transcription, word timestamps, and streaming sessions."""

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
from .speculative import (
    load_draft,
    speculative_decode_batch,
    speculative_greedy_decode,
    t0_verified_decode,
)
from .medusa import medusa_decode_batch, medusa_greedy_decode
from .beam import BeamResult, beam_decode, beam_decode_batch
from .language import detect_language, resolve_start_tokens
from .long_form import (
    split_windows,
    transcribe_long,
    transcribe_long_batch,
    unpack_long_form,
)
from .chunked import (
    chunk_layout,
    merge_longest_common_sequence,
    split_token_segments,
    transcribe_chunked,
)
from .word_timestamps import WordTiming, dtw_path, find_word_timestamps, split_words
from .streaming import StreamingTranscriber

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
    "load_draft",
    "speculative_decode_batch",
    "speculative_greedy_decode",
    "t0_verified_decode",
    "medusa_decode_batch",
    "medusa_greedy_decode",
    "BeamResult",
    "beam_decode",
    "beam_decode_batch",
    "detect_language",
    "resolve_start_tokens",
    "split_windows",
    "transcribe_long",
    "transcribe_long_batch",
    "unpack_long_form",
    "chunk_layout",
    "merge_longest_common_sequence",
    "split_token_segments",
    "transcribe_chunked",
    "WordTiming",
    "dtw_path",
    "find_word_timestamps",
    "split_words",
    "StreamingTranscriber",
]
