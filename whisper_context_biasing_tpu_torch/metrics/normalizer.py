"""Whisper-style basic text normalization.

Implements the same normalization contract as the reference's vendored copy of
OpenAI Whisper's ``BasicTextNormalizer`` (reference: utils/compute_metric.py:13-86),
which is itself the public OpenAI Whisper ``whisper/normalizers/basic.py`` algorithm:

  1. lowercase
  2. drop bracketed spans ``<...>``/``[...]`` and parenthesized spans ``(...)``
  3. unicode-normalize (NFKC, or NFKD when folding diacritics) and map every
     codepoint whose category starts with M/S/P (marks, symbols, punctuation)
     to a space; when ``remove_diacritics`` additionally drop Mn marks and fold
     a fixed table of non-decomposable letters
  4. collapse runs of whitespace to single spaces (leading/trailing space kept)

WER and B-WER both score normalized text, so this module must match the
reference byte-for-byte on its outputs; tests pin golden strings and the
committed eval artifacts.
"""

from __future__ import annotations

import re
import unicodedata

# Non-ASCII letters whose diacritics NFKD does not separate; folded explicitly
# when remove_diacritics=True. Same public table as OpenAI Whisper
# (reference: utils/compute_metric.py:13-30).
_UNDECOMPOSABLE_FOLDS = {
    "œ": "oe", "Œ": "OE",
    "ø": "o", "Ø": "O",
    "æ": "ae", "Æ": "AE",
    "ß": "ss", "ẞ": "SS",
    "đ": "d", "Đ": "D",
    "ð": "d", "Ð": "D",
    "þ": "th", "Þ": "th",
    "ł": "l", "Ł": "L",
}

_BRACKET_RE = re.compile(r"[<\[][^>\]]*[>\]]")
_PAREN_RE = re.compile(r"\(([^)]+?)\)")
_WS_RE = re.compile(r"\s+")


def fold_symbols_keep_diacritics(s: str) -> str:
    """NFKC-normalize and replace marks/symbols/punctuation with spaces.

    Mirrors reference utils/compute_metric.py:56-63.
    """
    out = []
    for ch in unicodedata.normalize("NFKC", s):
        out.append(" " if unicodedata.category(ch)[0] in "MSP" else ch)
    return "".join(out)


def fold_symbols_and_diacritics(s: str, keep: str = "") -> str:
    """NFKD-normalize, drop combining marks, fold special letters, and replace
    remaining marks/symbols/punctuation with spaces.

    Mirrors reference utils/compute_metric.py:33-53.
    """
    out = []
    for ch in unicodedata.normalize("NFKD", s):
        if ch in keep:
            out.append(ch)
        elif ch in _UNDECOMPOSABLE_FOLDS:
            out.append(_UNDECOMPOSABLE_FOLDS[ch])
        elif unicodedata.category(ch) == "Mn":
            continue
        elif unicodedata.category(ch)[0] in "MSP":
            out.append(" ")
        else:
            out.append(ch)
    return "".join(out)


class BasicTextNormalizer:
    """Callable normalizer; behavior-compatible with the reference class
    (utils/compute_metric.py:66-86)."""

    def __init__(self, remove_diacritics: bool = False, split_letters: bool = False):
        self._fold = (
            fold_symbols_and_diacritics if remove_diacritics else fold_symbols_keep_diacritics
        )
        self.split_letters = split_letters

    def __call__(self, s: str) -> str:
        s = s.lower()
        s = _BRACKET_RE.sub("", s)
        s = _PAREN_RE.sub("", s)
        s = self._fold(s).lower()
        if self.split_letters:
            # grapheme-cluster split; requires the third-party `regex` module
            import regex as _regex

            s = " ".join(_regex.findall(r"\X", s, _regex.U))
        s = _WS_RE.sub(" ", s)
        return s
