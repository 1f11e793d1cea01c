"""Metrics layer: Whisper-style text normalization, corpus WER, and the
count-based bias-word WER — host-side, validated against the reference's
committed eval artifacts (results/refs_and_pred_*.txt).

Pure Python and numpy: copies of the JAX package's ``metrics/`` modules, so
the port scores its transcripts without importing that package."""

from .normalizer import BasicTextNormalizer
from .wer import corpus_wer, word_edit_distance
from .evaluate import score_predictions
from .bias_wer import (
    BiasWerResult,
    compute_bias_wer,
    compute_bias_wer_from_words,
    parse_refs_and_pred_file,
)

__all__ = [
    "BasicTextNormalizer",
    "corpus_wer",
    "word_edit_distance",
    "BiasWerResult",
    "compute_bias_wer",
    "compute_bias_wer_from_words",
    "parse_refs_and_pred_file",
    "score_predictions",
]
