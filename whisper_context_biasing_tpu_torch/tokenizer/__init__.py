"""Tokenizer layer: self-contained byte-level BPE with the Whisper
special-token id layout (offline byte-fallback vocab or real vocab/merges)."""

from .bpe import ByteLevelBPE, bytes_to_unicode
from .whisper_tokenizer import LANGUAGES, WhisperTokenizer, load_tokenizer

__all__ = [
    "ByteLevelBPE",
    "bytes_to_unicode",
    "LANGUAGES",
    "WhisperTokenizer",
    "load_tokenizer",
]
