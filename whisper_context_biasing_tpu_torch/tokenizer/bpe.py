"""Byte-level BPE, GPT-2 style.

The reference delegates tokenization to HuggingFace's ``WhisperTokenizer``
(GPT-2 byte-level BPE + Whisper special tokens). This module implements the
same public algorithm from scratch so the framework is self-contained:

  * ``ByteLevelBPE.from_files(vocab.json, merges.txt)`` loads a real GPT-2 /
    Whisper vocabulary and reproduces its tokenization exactly, and
  * ``ByteLevelBPE.byte_fallback()`` provides a deterministic, offline vocab
    (one token per UTF-8 byte, ids 0..255, zero merges) so every pipeline
    contract — prompt construction, span matching, collation, decoding — is
    fully exercisable without any downloaded asset. Token *ids* differ from the
    real vocab but all id-space invariants (special-token layout, pad id) hold.

The pre-tokenization regex and byte<->unicode table are the standard public
GPT-2 definitions.
"""

from __future__ import annotations

import functools
import json
from typing import Iterable

import regex as _regex

# GPT-2 pre-tokenization pattern (public constant).
_PRETOKENIZE_RE = _regex.compile(
    r"""'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+"""
)


@functools.lru_cache(maxsize=1)
def bytes_to_unicode() -> dict[int, str]:
    """The reversible GPT-2 byte -> printable-unicode mapping (public algorithm):
    printable ascii/latin-1 bytes map to themselves, the rest are assigned
    codepoints 256+ in order."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("¡"), ord("¬") + 1))
        + list(range(ord("®"), ord("ÿ") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


@functools.lru_cache(maxsize=1)
def unicode_to_bytes() -> dict[str, int]:
    return {v: k for k, v in bytes_to_unicode().items()}


class ByteLevelBPE:
    """A byte-level BPE codec over a fixed vocabulary + ranked merge list."""

    def __init__(self, encoder: dict[str, int], merges: list[tuple[str, str]]):
        self.encoder = dict(encoder)
        self.decoder = {v: k for k, v in self.encoder.items()}
        self.bpe_ranks = {pair: i for i, pair in enumerate(merges)}
        self._cache: dict[str, tuple[str, ...]] = {}
        self._byte_encoder = bytes_to_unicode()
        self._byte_decoder = unicode_to_bytes()

    # -- constructors ---------------------------------------------------------

    @classmethod
    def from_files(cls, vocab_path: str, merges_path: str) -> "ByteLevelBPE":
        with open(vocab_path, encoding="utf-8") as f:
            encoder = json.load(f)
        merges: list[tuple[str, str]] = []
        with open(merges_path, encoding="utf-8") as f:
            for line in f:
                line = line.rstrip("\n")
                if not line or line.startswith("#version"):
                    continue
                a, b = line.split(" ")
                merges.append((a, b))
        return cls(encoder, merges)

    @classmethod
    def from_tokenizer_json(cls, path: str) -> "ByteLevelBPE":
        """Load from an HF ``tokenizer.json`` (the single-file fast-tokenizer
        format real Whisper checkpoints ship): reads model.vocab and
        model.merges of the BPE section."""
        with open(path, encoding="utf-8") as f:
            data = json.load(f)
        model = data.get("model", {})
        if model.get("type") not in (None, "BPE"):
            raise ValueError(f"unsupported tokenizer model type {model.get('type')}")
        encoder = model["vocab"]
        merges: list[tuple[str, str]] = []
        for m in model.get("merges", []):
            if isinstance(m, str):
                a, b = m.split(" ")
            else:
                a, b = m
            merges.append((a, b))
        return cls(encoder, merges)

    @classmethod
    def byte_fallback(cls, vocab_size: int = 50257) -> "ByteLevelBPE":
        """Offline vocabulary: token id b = byte b (via the GPT-2 byte table),
        no merges. ids 256..vocab_size-1 are reserved/unused filler tokens so the
        id space has the same extent as GPT-2's (specials stack above it)."""
        b2u = bytes_to_unicode()
        encoder = {b2u[b]: b for b in range(256)}
        for i in range(256, vocab_size):
            encoder[f"<unused_{i}>"] = i
        return cls(encoder, [])

    # -- BPE core --------------------------------------------------------------

    def _bpe(self, token: str) -> tuple[str, ...]:
        cached = self._cache.get(token)
        if cached is not None:
            return cached
        word = tuple(token)
        if not self.bpe_ranks:
            self._cache[token] = word
            return word
        while len(word) > 1:
            pairs = {(word[i], word[i + 1]) for i in range(len(word) - 1)}
            best = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if best not in self.bpe_ranks:
                break
            first, second = best
            merged: list[str] = []
            i = 0
            while i < len(word):
                if i < len(word) - 1 and word[i] == first and word[i + 1] == second:
                    merged.append(first + second)
                    i += 2
                else:
                    merged.append(word[i])
                    i += 1
            word = tuple(merged)
        self._cache[token] = word
        return word

    # -- public API --------------------------------------------------------------

    @property
    def vocab_size(self) -> int:
        return len(self.encoder)

    def encode(self, text: str) -> list[int]:
        ids: list[int] = []
        for chunk in _PRETOKENIZE_RE.findall(text):
            mapped = "".join(self._byte_encoder[b] for b in chunk.encode("utf-8"))
            for piece in self._bpe(mapped):
                ids.append(self.encoder[piece])
        return ids

    def decode(self, ids: Iterable[int]) -> str:
        pieces = [self.decoder.get(int(i), "") for i in ids]
        text = "".join(pieces)
        data = bytes(self._byte_decoder[c] for c in text if c in self._byte_decoder)
        return data.decode("utf-8", errors="replace")
