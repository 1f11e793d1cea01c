"""Corpus word error rate.

Equivalent to ``evaluate.load("wer")`` / jiwer as used by the reference's
``compute_wer`` callback (reference: utils/compute_metric.py:90,159):

    WER = (total substitutions + deletions + insertions over all pairs)
          / (total reference words over all pairs)

i.e. a *corpus-level* (micro-averaged) metric: per-pair word-level Levenshtein
distances are summed and divided by the summed reference lengths.

Implemented host-side in numpy; the sequences are short (spoken sentences), so
a banded-free O(N*M) DP per pair is plenty fast (vectorized over one axis).
"""

from __future__ import annotations

from typing import Iterable, Sequence

import numpy as np


def word_edit_distance(ref: Sequence[str], hyp: Sequence[str]) -> int:
    """Levenshtein distance between two word sequences (unit costs)."""
    n, m = len(ref), len(hyp)
    if n == 0:
        return m
    if m == 0:
        return n
    # Intern words to ints for fast vector compares.
    vocab: dict[str, int] = {}
    r = np.fromiter((vocab.setdefault(w, len(vocab)) for w in ref), dtype=np.int32, count=n)
    h = np.fromiter((vocab.setdefault(w, len(vocab)) for w in hyp), dtype=np.int32, count=m)

    prev = np.arange(m + 1, dtype=np.int32)
    cur = np.empty(m + 1, dtype=np.int32)
    for i in range(1, n + 1):
        cur[0] = i
        sub = prev[:-1] + (h != r[i - 1])  # substitution / match
        dele = prev[1:] + 1                # deletion (from hyp's perspective: ref word dropped)
        np.minimum(sub, dele, out=sub)
        # insertion needs a sequential scan
        run = cur[0]
        for j in range(1, m + 1):
            run = min(sub[j - 1], run + 1)
            cur[j] = run
        prev, cur = cur, prev
    return int(prev[m])


def corpus_wer(references: Iterable[str], predictions: Iterable[str]) -> float:
    """Corpus WER over whitespace-tokenized text pairs. Returns a fraction
    (multiply by 100 for percent, as the reference does at
    utils/compute_metric.py:159)."""
    total_dist = 0
    total_words = 0
    for ref, hyp in zip(references, predictions):
        ref_words = ref.split()
        hyp_words = hyp.split()
        total_dist += word_edit_distance(ref_words, hyp_words)
        total_words += len(ref_words)
    if total_words == 0:
        raise ValueError("corpus_wer: no reference words")
    return total_dist / total_words
