"""Data layer: the batch collator's bias-span padding contract."""

from .collator import BIAS_SPAN_PAD_ID, SpeechSeq2SeqCollator

__all__ = ["BIAS_SPAN_PAD_ID", "SpeechSeq2SeqCollator"]
