"""Count-based bias-word WER (B-WER).

Behavior-compatible with the reference's ``compute_bias_wer``
(utils/compute_metric.py:165-239). This is NOT an alignment-based WER; it is a
substring-count recall/precision proxy:

  for each sample, for each (normalized) bias word present in the normalized
  reference:
      sample_tokens   += len(bias words' tokens) * count(bias in ref)
      sample_distance += |count(bias in ref) - count(bias in pred)| * len(tokens)
  B-WER = 100 * sum(sample_distance) / sum(sample_tokens)

Quirks preserved deliberately (they define the published numbers):
  * counting is raw ``str.count`` over ``' '.join(words)`` — substring matches,
    not word-boundary matches (utils/compute_metric.py:216,222)
  * samples where no bias word appears in the reference contribute nothing,
    gated by ``sample_tokens > 0`` (utils/compute_metric.py:228-232)
  * bias words that normalize to the empty string are skipped

The ``refs_and_pred.txt`` artifact parser replicates the reference's
line-oriented state machine (utils/compute_metric.py:173-188) byte-for-byte so
the committed eval artifacts in the reference repo parse identically.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Sequence

from .normalizer import BasicTextNormalizer


def parse_refs_and_pred_file(path: str) -> tuple[list[str], list[str]]:
    """Parse a ``Ref : ...\\nPred: ...\\n\\n`` artifact into (refs, preds).

    Same acceptance rules as the reference parser (utils/compute_metric.py:173-188):
    a pair is consumed only when a line starting with ``'Ref :'`` is immediately
    followed by a line starting with ``'Pred:'``; both are sliced at column 6
    then stripped.
    """
    if not os.path.isfile(path):
        raise FileNotFoundError(f"refs/pred artifact not found: {path}")
    refs: list[str] = []
    preds: list[str] = []
    with open(path, "r", encoding="utf-8") as f:
        lines = f.readlines()
    i = 0
    while i < len(lines):
        if lines[i].startswith("Ref :"):
            if i + 1 < len(lines) and lines[i + 1].startswith("Pred:"):
                refs.append(lines[i][6:].strip())
                preds.append(lines[i + 1][6:].strip())
                i += 3
            else:
                i += 1
        else:
            i += 1
    return refs, preds


@dataclass
class BiasWerResult:
    bias_wer: float  # percent
    total_distance: int
    total_tokens: int
    per_sample: list[float]

    def as_dict(self) -> dict:
        # same artifact schema the reference writes to *_bias_wer_results.json
        return {"bias_wer": self.bias_wer}


def compute_bias_wer_from_words(
    refs: Sequence[str],
    preds: Sequence[str],
    bias_words_per_sample: Sequence[Sequence[str]],
) -> BiasWerResult:
    """Core B-WER over already-decoded bias words (one list per sample)."""
    if len(refs) != len(bias_words_per_sample):
        raise ValueError(
            f"sample count mismatch: {len(refs)} refs vs "
            f"{len(bias_words_per_sample)} bias lists"
        )
    normalizer = BasicTextNormalizer()
    total_distance = 0
    total_tokens = 0
    per_sample: list[float] = []

    for ref, pred, bias_words in zip(refs, preds, bias_words_per_sample):
        if not bias_words:
            continue
        norm_ref = normalizer(ref)
        norm_pred = normalizer(pred)
        ref_joined = " ".join(norm_ref.split())
        pred_joined = " ".join(norm_pred.split())

        sample_distance = 0
        sample_tokens = 0
        for word in bias_words:
            norm_word = normalizer(word.lower())
            word_tokens = norm_word.split()
            if not word_tokens:
                continue
            # NOTE: substring count on purpose — see module docstring.
            ref_count = ref_joined.count(norm_word)
            if ref_count == 0:
                continue
            sample_tokens += len(word_tokens) * ref_count
            pred_count = pred_joined.count(norm_word)
            if pred_count != ref_count:
                sample_distance += abs(ref_count - pred_count) * len(word_tokens)

        if sample_tokens > 0:
            per_sample.append(sample_distance / sample_tokens)
            total_distance += sample_distance
            total_tokens += sample_tokens

    if total_tokens == 0:
        return BiasWerResult(0.0, 0, 0, per_sample)
    return BiasWerResult(100.0 * total_distance / total_tokens, total_distance, total_tokens, per_sample)


def compute_bias_wer(refs_pred_file: str, bias_spans, tokenizer) -> dict:
    """Reference-API-compatible entry point (utils/compute_metric.py:165):
    parses the artifact file, decodes each sample's token-id spans back to
    words with ``tokenizer``, and returns ``{"bias_wer": percent}``.
    """
    refs, preds = parse_refs_and_pred_file(refs_pred_file)
    if len(refs) != len(bias_spans):
        raise ValueError(
            f"sample count mismatch: {len(refs)} refs vs {len(bias_spans)} bias_spans"
        )
    words_per_sample = [
        [tokenizer.decode(span, skip_special_tokens=True).lower() for span in spans]
        for spans in bias_spans
    ]
    result = compute_bias_wer_from_words(refs, preds, words_per_sample)
    return result.as_dict()
